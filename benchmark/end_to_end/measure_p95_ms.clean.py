"""measure_p95_ms.clean: `measure_p95_ms` in the healthy fleet's cell (`monitor.clean-64`),
named apart so that its bound follows that cell's own spread: the call
there is short and host-bound, and spreads several times as widely as
`monitor.mixed-64`'s."""

from benchmark.core.spec import load_module

compute = load_module("end_to_end", "measure_p95_ms").compute
