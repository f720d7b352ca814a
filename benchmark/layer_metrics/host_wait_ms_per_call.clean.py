"""host_wait_ms_per_call.clean: `host_wait_ms_per_call` in the healthy fleet's cell
(`monitor.clean-64`), which reports its own end-to-end metrics."""

from benchmark.core.spec import load_module

_same = load_module("layer_metrics", "host_wait_ms_per_call")
COUNTERS, read = _same.COUNTERS, _same.read
