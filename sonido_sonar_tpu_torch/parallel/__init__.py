"""Batched pipelines and corpus matching (counterpart of
`sonido_sonar_tpu/parallel/`; the mesh is not ported yet)."""

from sonido_sonar_tpu_torch.parallel.pipeline import (  # noqa: F401
    batched_fingerprint_features,
    batched_pair_alignment,
    batched_pair_dtw,
    batched_refine_offsets,
)
from sonido_sonar_tpu_torch.parallel.matcher import (  # noqa: F401
    fingerprint_matrix,
    pack_statistics,
    sharded_top_k_matches,
)
