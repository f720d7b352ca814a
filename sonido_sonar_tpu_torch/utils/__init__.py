"""Utilities: fingerprint serialization, state conversion from the JAX
package, parity checks and timing metrics."""

from sonido_sonar_tpu_torch.utils.serialize import (  # noqa: F401
    fingerprint_to_json,
    load_fingerprint_npz,
    save_fingerprint_npz,
)
from sonido_sonar_tpu_torch.utils.metrics import (  # noqa: F401
    Metrics,
    get_global_metrics,
    profiler_trace,
)
