"""staged_pushes_per_call: the pushes of a monitor call that go to the
card through pinned memory (span `monitor.stage`'s count, one entry a
staged push), over the traced calls. Two a call where each
side's numpy chunk is staged; 0 where the windows are on the CPU; no
reading from a program without the span."""

from benchmark.core.spec import load_module

_t = load_module("layer_metrics", "_totals")
COUNTERS = _t.present({"monitor_stage_count": "sonido_sonar_tpu_torch.monitor:STAGE.count"})


def read(ctx):
    return _t.per_call(ctx, list(COUNTERS))
