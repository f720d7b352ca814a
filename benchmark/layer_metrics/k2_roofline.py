"""k2_roofline: K2's least time (roofline/k2.py: the least-work YIN by
real FFTs over 67 TFLOP/s fp32) over its device time, in the traced
batches."""

from benchmark.core.kernels import picker
from benchmark.roofline import k2, peaks

COUNTERS = {"k2_launches": "sonido_sonar_tpu_torch.ops.hopper_yin:yin_pitch_hopper.launches"}


def read(ctx):
    cfg = ctx.cell.config
    seconds = ctx.trace.device_seconds(picker(ctx.kernels, "k2"))
    launches = ctx.counters["k2_launches"]
    if launches == 0 or seconds <= 0:
        return None
    n = int(cfg["clip_seconds"] * cfg["sample_rate"])
    least = peaks.least_seconds(*k2.counts(int(cfg["batch"]), n, int(cfg["pitch_window"]), int(cfg["pitch_hop"])))
    return 100.0 * launches * least / seconds
