"""Measure CDN end-to-end latency between two audio files.

Usage: python -m sonido_sonar_tpu_torch.examples.cdn_latency source.wav cdn.wav [max_lag_seconds]

Decode -> FingerprintGenerator (both files) -> extract_alignment_features
-> refine_offset_with_pcm. `main` returns the latency, the frame-level
offset and the wall time of each stage (ms; each stage ends synchronized
with the device).
"""

import sys

from sonido_sonar_tpu_torch.config.config import FeatureConfig, FingerprintConfig
from sonido_sonar_tpu_torch.extractors import AlignmentExtractor
from sonido_sonar_tpu_torch.fingerprint import FingerprintGenerator
from sonido_sonar_tpu_torch.io.decode import Decoder
from sonido_sonar_tpu_torch.utils.device import DEFAULT_DEVICE, Device, as_float32
from sonido_sonar_tpu_torch.utils.metrics import Metrics


def main(src_path: str, cdn_path: str, max_lag: float = 30.0,
         device: Device = DEFAULT_DEVICE) -> dict:
    stages = Metrics()
    with stages.timer("decode"):
        dec = Decoder()
        source = dec.decode_file(src_path)
        cdn = dec.decode_file(cdn_path)

    cfg = FeatureConfig(sample_rate=source.sample_rate, window_size=1024, hop_size=256)
    with stages.timer("fingerprints", block_on=device):
        gen = FingerprintGenerator(FingerprintConfig(feature_config=cfg), device=device)
        fp_src = gen.generate_fingerprint(source)
        fp_cdn = gen.generate_fingerprint(cdn)

    with stages.timer("alignment", block_on=device):
        ext = AlignmentExtractor(cfg, max_lag_seconds=max_lag, device=device)
        src_pcm, cdn_pcm = as_float32(source.pcm, device), as_float32(cdn.pcm, device)
        al = ext.extract_alignment_features(
            fp_src.features, fp_cdn.features, src_pcm, cdn_pcm, source.sample_rate,
        )
    with stages.timer("refine", block_on=device):
        refined = ext.refine_offset_with_pcm(
            src_pcm, cdn_pcm, source.sample_rate, al.temporal_offset,
        )
    print(f"content type : {fp_src.content_type.value}")
    print(f"latency      : {refined*1000:.2f} ms "
          f"(frame-level {al.temporal_offset*1000:.1f} ms)")
    print(f"confidence   : {al.offset_confidence:.2f} ({al.method})")
    print(f"similarity   : {al.alignment_similarity:.3f}")
    for k, v in ext.get_alignment_summary(al).items():
        print(f"  {k}: {v}")
    ms = {k: v["total_s"] * 1000 for k, v in stages.snapshot()["stages"].items()}
    return {"latency_s": refined, "coarse_s": al.temporal_offset,
            "confidence": al.offset_confidence, "method": al.method,
            "content_type": fp_src.content_type.value, "ms": ms}


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], float(sys.argv[3]) if len(sys.argv) > 3 else 30.0)
