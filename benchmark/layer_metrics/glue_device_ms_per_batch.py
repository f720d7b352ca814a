"""glue_device_ms_per_batch: device time per batch of the main path's
eager PyTorch kernels, every kernel but the port's own `csrc` kernels
(copies and memsets are not kernels), in the traced batches."""

from benchmark.core.kernels import is_kernel, picker


def read(ctx):
    own = picker(ctx.kernels, "csrc")
    return 1e3 * ctx.trace.device_seconds(lambda s: is_kernel(s) and not own(s)) / ctx.trace.calls
