"""k4_roofline: K4 with its least time (roofline/k4.py over the cells its
launches took, `thin_onsets_hopper.cells`) over its device time, in the
traced batches. K4's records are the trace's `thin_kernel` records; the
reading is given only where they are as many as the launches counted
(`thin_onsets_hopper.launches`)."""

from benchmark.core.spec import load_module
from benchmark.roofline import k4, peaks

_t = load_module("layer_metrics", "_totals")
COUNTERS = _t.present({
    "k4_launches": "sonido_sonar_tpu_torch.ops.hopper_onsets:thin_onsets_hopper.launches",
    "k4_cells": "sonido_sonar_tpu_torch.ops.hopper_onsets:thin_onsets_hopper.cells",
})
KERNEL = "thin_kernel"


def records(ctx) -> list:
    lo, hi = ctx.trace.window.ts, ctx.trace.window.end
    return [s for s in ctx.trace.device if s.cat == "kernel" and KERNEL in s.name.lower()
            and s.end > lo and s.ts < hi]


def read(ctx):
    if any(n not in ctx.counters for n in ("k4_launches", "k4_cells")):
        return None
    launches, cells = ctx.counters["k4_launches"], ctx.counters["k4_cells"]
    found = records(ctx)
    seconds = sum(min(s.end, ctx.trace.window.end) - max(s.ts, ctx.trace.window.ts) for s in found) * 1e-6
    if launches == 0 or len(found) != launches or seconds <= 0:
        return None
    return 100.0 * peaks.least_seconds(*k4.counts(cells)) / seconds
