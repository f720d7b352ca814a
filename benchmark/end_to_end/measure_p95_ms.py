"""measure_p95_ms: the 95th percentile, in ms, of every measurement call
the window started (a push of the interval's audio and `measure_all`, up
to the measurements on the host)."""

from benchmark.core.window import percentile


def compute(run) -> float:
    return 1e3 * percentile(run.window.latencies_s(), 95.0)
