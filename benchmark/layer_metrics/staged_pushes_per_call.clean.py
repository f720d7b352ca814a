"""staged_pushes_per_call.clean: `staged_pushes_per_call` in the healthy
fleet's cell (`monitor.clean-64`), which reports its own end-to-end metrics."""

from benchmark.core.spec import load_module

_same = load_module("layer_metrics", "staged_pushes_per_call")
COUNTERS, read = _same.COUNTERS, _same.read
