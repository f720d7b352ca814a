"""PyTorch + CUDA port of sonido-sonar-tpu for NVIDIA Hopper (H100).

The layout mirrors `sonido_sonar_tpu/` module for module. Plain tensor
math is PyTorch; the JAX package's Pallas kernels become CUDA C++ kernels
under `csrc/`, built with nvcc for sm_90a at first use (`_build.py`).

Every kernel wrapper takes its plain PyTorch version for a tensor on the
CPU and launches its kernel (or raises) for a tensor on a CUDA device.

Entry points of the ported slices:

    from sonido_sonar_tpu_torch.parallel.pipeline import (
        batched_fingerprint_features,
    )
    feats = batched_fingerprint_features(pcm)   # pcm: [B, N] float32 tensor

    from sonido_sonar_tpu_torch.fingerprint import FingerprintGenerator
    fps = FingerprintGenerator().generate_fingerprints_batch(audios)

This package never imports JAX or `sonido_sonar_tpu`.
"""
