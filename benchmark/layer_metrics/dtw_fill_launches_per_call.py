"""dtw_fill_launches_per_call: the port's banded DTW fill launches
(`ops/stats/hopper_dtw.fill_banded_hopper.launches`, an exact count) per
measurement call, over the traced calls. Two at 64 pairs when each
sub-batch of 32 holds a pair that fails the 0.7 gate; 0 when all pass."""


COUNTERS = {"dtw_fill_launches": "sonido_sonar_tpu_torch.ops.stats.hopper_dtw:fill_banded_hopper.launches"}


def read(ctx):
    return ctx.counters["dtw_fill_launches"] / ctx.trace.calls
