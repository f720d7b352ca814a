"""Scale-out: device meshes, sharded batch pipelines, corpus search
(counterpart of `sonido_sonar_tpu/parallel/`).

The batch axis (streams x chunks) is split over a mesh of devices
(`mesh.py`: each entry a `torch.device`, each shard's rows on its
entry's device); the frame axis is vectorized inside each device.
Fingerprint generation is embarrassingly parallel (no collectives);
corpus-wide matching merges each shard's top k, all-gathered across the
ranks of a process group.
"""

from sonido_sonar_tpu_torch.parallel.mesh import (  # noqa: F401
    data_sharding,
    make_mesh,
    replicated,
    shard_batch,
    shard_over_batch,
)
from sonido_sonar_tpu_torch.parallel.pipeline import (  # noqa: F401
    BatchedFingerprintPipeline,
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
