"""h2d_ms_per_batch: device time of host-to-device copies per batch, in
the traced batches: the staging upload of `run_stream`."""

from benchmark.core.kernels import picker


def read(ctx):
    h2d = picker(ctx.kernels, "h2d")
    return 1e3 * ctx.trace.device_seconds(lambda s: s.cat == "gpu_memcpy" and h2d(s)) / ctx.trace.calls
