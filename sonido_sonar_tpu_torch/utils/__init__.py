"""Utilities: fingerprint serialization, state conversion from the JAX
package, parity checks, spans and stage timers."""

from sonido_sonar_tpu_torch.utils.serialize import (  # noqa: F401
    fingerprint_to_json,
    load_fingerprint_npz,
    save_fingerprint_npz,
)
from sonido_sonar_tpu_torch.utils.metrics import (  # noqa: F401
    Metrics,
    profiler_trace,
)
