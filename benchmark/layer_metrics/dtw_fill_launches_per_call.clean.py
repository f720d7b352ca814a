"""dtw_fill_launches_per_call.clean: `dtw_fill_launches_per_call` in the healthy fleet's cell
(`monitor.clean-64`), which reports its own end-to-end metrics."""

from benchmark.core.spec import load_module

_same = load_module("layer_metrics", "dtw_fill_launches_per_call")
COUNTERS, read = getattr(_same, "COUNTERS", {}), _same.read
