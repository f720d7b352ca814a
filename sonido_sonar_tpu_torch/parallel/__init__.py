"""Batched pipelines (counterpart of `sonido_sonar_tpu/parallel/`)."""

from sonido_sonar_tpu_torch.parallel.pipeline import (  # noqa: F401
    batched_fingerprint_features,
    batched_pair_alignment,
    batched_pair_dtw,
    batched_refine_offsets,
)
