"""Driver of the port's public entry point, `FingerprintGenerator.
generate_fingerprints_batch` (`fingerprint/generator.py`), on clips whose
metadata gives their content type: upstream's `DefaultFingerprintConfig`
with content detection on, routing not strict, each clip an `AudioData`
with `AudioMetadata(extra={"content_type": <the configuration's type>})`,
so the generator takes the type from the metadata, dispatches no
detection and runs the type's extractor once over the whole batch.

Set-up makes the `distinct` batches on the card from the seed, builds
the generator and runs every batch once, so the shapes are warm before
the window; it refuses to start when a warm batch comes out in more than
one group or typed otherwise. The window, the sampled batches and the
check are `content_generator.py`'s: a closed loop, one batch a call, a
call complete when its fingerprints are on the host (`materialize`).
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch

from benchmark.core import spec as S
from benchmark.drivers import content_generator
from benchmark.drivers.content_generator import as_checked  # noqa: F401  (the tests read a batch with it)


class Driver(content_generator.Driver):
    def __init__(self, config: dict, traffic: dict, check: dict, seed: int, device):
        from sonido_sonar_tpu_torch.config.config import FeatureConfig, FingerprintConfig, WindowType
        from sonido_sonar_tpu_torch.fingerprint import FingerprintGenerator
        from sonido_sonar_tpu_torch.io.audio import AudioData, AudioMetadata

        self.cfg = config
        self.device = torch.device(device)
        sr = int(config["sample_rate"])
        if (traffic["batch"], traffic["clip_seconds"]) != (config["batch"], config["clip_seconds"]):
            raise ValueError("the traffic's batch shape differs from the configuration's")
        if traffic["content_type"] != config["content_type"]:
            raise ValueError("the traffic's tag differs from the configuration's content type")
        self.batches = S.traffic(traffic, seed, self.device, sr)
        tag = AudioMetadata(extra={"content_type": config["content_type"]})
        self.audios = [[AudioData(row, sr, metadata=tag) for row in b] for b in self.batches]
        self.audio_s = float(traffic["batch"] * traffic["clip_seconds"])
        fp_config = FingerprintConfig(feature_config=FeatureConfig(
            sample_rate=sr, window_size=int(config["window_size"]), hop_size=int(config["hop_size"]),
            window_type=WindowType(config["window_type"]),
            mfcc_coefficients=int(config["mfcc_coefficients"]),
            contrast_bands=int(config["contrast_bands"])))
        if not (fp_config.content_aware.enable_content_detection and config["content_detection"]
                and config["materialize"]):
            raise ValueError("the configuration runs with content detection on and materialized output")
        self.gen = FingerprintGenerator(fp_config, strict_reference_routing=bool(config["strict_reference_routing"]),
                                        device=self.device)
        self.rng = np.random.default_rng([int(seed) & ((1 << 63) - 1), 0x5EED])
        pool, n = int(check["sample_pool"]), int(check["sample"])
        self.keep_at = set(self.rng.choice(pool, size=n - 1, replace=False).tolist())
        self.kept: Dict[int, list] = {}
        self.count = 0
        for i in range(len(self.batches)):   # the warm batches
            seen = sorted({(fp.content_type.value, fp.metadata["extractor_name"]) for fp in self._call()})
            print(f"batch {i}: (content type, extractor) {seen}", file=sys.stderr)
            if len(seen) != 1 or seen[0][0] != config["content_type"]:
                raise RuntimeError(f"batch {i} came out as {seen}, not one group of {config['content_type']!r}")
