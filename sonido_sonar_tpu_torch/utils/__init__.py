"""Utilities: state conversion from the JAX package, parity checks and
timing metrics."""

from sonido_sonar_tpu_torch.utils.metrics import Metrics, get_global_metrics  # noqa: F401
