"""PyTorch + CUDA port of sonido-sonar-tpu for NVIDIA Hopper (H100).

The layout mirrors `sonido_sonar_tpu/` module for module. Plain tensor
math is PyTorch; the JAX package's Pallas kernels become CUDA C++ kernels
under `csrc/`, built with nvcc for sm_90a at first use (`_build.py`).

Every kernel wrapper takes its plain PyTorch version for a tensor on the
CPU and launches its kernel (or raises) for a tensor on a CUDA device.
The entry points run on the card unless asked for the CPU: a tensor
stays on its device, numpy input goes to their `device` argument, which
defaults to "cuda" (`utils/device.py`).

Entry points of the ported slices:

    from sonido_sonar_tpu_torch.parallel.pipeline import (
        batched_fingerprint_features,
    )
    feats = batched_fingerprint_features(pcm)   # pcm: [B, N] float32 tensor

    from sonido_sonar_tpu_torch.fingerprint import FingerprintGenerator
    from sonido_sonar_tpu_torch.io import Decoder
    audio = Decoder().decode_file("clip.wav")   # host float32 PCM
    fp = FingerprintGenerator().generate_fingerprint(audio)
    fps = FingerprintGenerator().generate_fingerprints_batch(audios)

    from sonido_sonar_tpu_torch import FleetMonitor
    fleet = FleetMonitor(FeatureConfig(44100, 1024, 256), n_streams=64,
                         device="cuda")
    fleet.push_source_all(src)    # [64, L] chunks, tensors or arrays
    fleet.push_cdn_all(cdn)
    latencies = fleet.measure_all()

Scale-out and cold start:

    from sonido_sonar_tpu_torch.parallel import (
        BatchedFingerprintPipeline, make_mesh,
    )
    pipe = BatchedFingerprintPipeline(make_mesh(), FeatureConfig(44100, 1024, 256))
    feats = pipe(pcm)               # [B, N], B split over the CUDA devices

    from sonido_sonar_tpu_torch import warmup
    warmup(cache_dir="/var/cache/sonido_kernels")  # build once per fleet

The JAX examples and accuracy sweep run as modules:
`python -m sonido_sonar_tpu_torch.examples.cdn_latency src.wav cdn.wav`,
`python -m sonido_sonar_tpu_torch.eval_accuracy --full`.

This package never imports JAX or `sonido_sonar_tpu`.
"""
from sonido_sonar_tpu_torch.config import (  # noqa: F401,E402
    AlignmentConfig,
    ComparisonConfig,
    ContentType,
    FeatureConfig,
    FingerprintConfig,
)
from sonido_sonar_tpu_torch.monitor import (  # noqa: F401,E402
    FleetMonitor,
    LatencyMeasurement,
    LatencyMonitor,
)
from sonido_sonar_tpu_torch.warmup import (  # noqa: F401,E402
    enable_persistent_cache,
    warmup,
)
