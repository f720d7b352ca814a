"""dtw_roofline: the banded DTW's least time as one unit (roofline/dtw.py:
the band cells' operations, the series read and the path written once)
over the device time of the fill and backtrack kernels, in the traced
calls. Nothing to read where no fill ran."""

from benchmark.core.kernels import picker
from benchmark.roofline import dtw, peaks

COUNTERS = {"dtw_fill_launches": "sonido_sonar_tpu_torch.ops.stats.hopper_dtw:fill_banded_hopper.launches"}


def read(ctx):
    cfg = ctx.cell.config
    launches = ctx.counters["dtw_fill_launches"]
    seconds = ctx.trace.device_seconds(picker(ctx.kernels, "dtw"))
    if launches == 0 or seconds <= 0:
        return None
    sr, hop, win = cfg["sample_rate"], cfg["hop_size"], cfg["window_size"]
    n = (int(cfg["window_seconds"] * sr) - win) // hop + 1
    band = min(max(cfg["dtw_band_min_frames"], int(cfg["max_lag_seconds"] * sr) // hop), n)
    per_launch = peaks.least_seconds(*dtw.counts(int(cfg["measure_batch"]), n, n, band))
    return 100.0 * launches * per_launch / seconds
