"""push_ms_per_call: host ms of a monitor call's pushes (span
`monitor.push`: the blocking copy of each numpy chunk to the card and
the rolling window's shift), over the traced calls."""

from benchmark.core.spec import load_module

_t = load_module("layer_metrics", "_totals")
COUNTERS = _t.present({"monitor_push_ns": "sonido_sonar_tpu_torch.monitor:PUSH.total_ns"})


def read(ctx):
    return _t.per_call(ctx, list(COUNTERS), 1e-6)
