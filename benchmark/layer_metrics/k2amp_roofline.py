"""k2amp_roofline: K2 with the period amplitude's least time
(roofline/k2amp.py over the rows its launches took) over its device
time, in the traced batches.

The amplitude launches are the same kernel as the pitch launches
(`yin_kernel`, the k2 group), so the reader tells them apart by the
speech program's order: each extractor call launches K1 once, then K2
for its pitch track, then, where the group's flags run the speech chain,
K2 with the amplitude before the next call's K1. A k2 record whose
previous K1-or-K2 record is a pitch launch's k2 record is an amplitude
launch. The reading is given only where the records so found are as
many as the launches counted (`yin_pitch_hopper.amp_launches`)."""

from benchmark.core.kernels import picker
from benchmark.core.spec import load_module
from benchmark.roofline import k2amp, peaks

_t = load_module("layer_metrics", "_totals")
COUNTERS = _t.present({
    "k2amp_launches": "sonido_sonar_tpu_torch.ops.hopper_yin:yin_pitch_hopper.amp_launches",
    "k2amp_rows": "sonido_sonar_tpu_torch.ops.hopper_yin:yin_pitch_hopper.amp_rows",
})


def amplitude_records(ctx) -> list:
    """The k2 records of the traced window that are amplitude launches."""
    is_k1, is_k2 = picker(ctx.kernels, "k1"), picker(ctx.kernels, "k2")
    lo, hi = ctx.trace.window.ts, ctx.trace.window.end
    seq = sorted((s for s in ctx.trace.device if s.end > lo and s.ts < hi and (is_k1(s) or is_k2(s))),
                 key=lambda s: s.ts)
    out, after_pitch = [], False
    for s in seq:
        if is_k2(s) and after_pitch:
            out.append(s)
            after_pitch = False
        else:
            after_pitch = is_k2(s)
    return out


def read(ctx):
    if any(n not in ctx.counters for n in ("k2amp_launches", "k2amp_rows")):
        return None
    launches, rows = ctx.counters["k2amp_launches"], ctx.counters["k2amp_rows"]
    found = amplitude_records(ctx)
    seconds = sum(min(s.end, ctx.trace.window.end) - max(s.ts, ctx.trace.window.ts) for s in found) * 1e-6
    if launches == 0 or len(found) != launches or seconds <= 0:
        return None
    cfg = ctx.cell.config
    n = int(cfg["clip_seconds"] * cfg["sample_rate"])
    least = peaks.least_seconds(*k2amp.counts(rows, n, int(cfg["voice_quality_window"]),
                                              int(cfg["voice_quality_hop"])))
    return 100.0 * least / seconds
