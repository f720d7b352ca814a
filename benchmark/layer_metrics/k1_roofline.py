"""k1_roofline: K1's least time (roofline/k1.py: the PCM read once, the
magnitudes and aux written once, over 3.35 TB/s) over its device time,
in the traced batches."""

from benchmark.core.kernels import picker
from benchmark.roofline import k1, peaks

COUNTERS = {"k1_launches": "sonido_sonar_tpu_torch.ops.hopper_stft:stft_magnitude_hopper.launches"}


def read(ctx):
    cfg = ctx.cell.config
    seconds = ctx.trace.device_seconds(picker(ctx.kernels, "k1"))
    launches = ctx.counters["k1_launches"]
    if launches == 0 or seconds <= 0:
        return None
    n = int(cfg["clip_seconds"] * cfg["sample_rate"])
    least = peaks.least_seconds(*k1.counts(int(cfg["batch"]), n, int(cfg["window_size"]), int(cfg["hop_size"])))
    return 100.0 * launches * least / seconds
