"""Statistical / alignment primitives (reference: algorithms/stats).

Counterpart of `sonido_sonar_tpu/ops/stats/`: cross-correlation, DTW
(dense and banded; the banded fill and backtrack are CUDA kernels,
`hopper_dtw.py` and `hopper_backtrack.py`), the hybrid alignment analyzer
and its batched counterpart; distance functions (`distance.py`),
clustering (`clustering.py`), entropy (`entropy.py`), moments
(`moments.py`) and percentiles (`percentiles.py`).
"""

from sonido_sonar_tpu_torch.ops.stats.correlation import (  # noqa: F401
    CorrelationResult,
    autocorrelate,
    cross_correlate,
    cross_correlate_fft,
    z_normalize,
)
from sonido_sonar_tpu_torch.ops.stats.dtw import (  # noqa: F401
    DTWResult,
    dtw_align,
    dtw_align_banded,
    dtw_align_vectors,
)
