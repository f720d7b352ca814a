"""fft_device_ms_per_call: device time of cuFFT's kernels (the NCC lag
scan, the PCM verification's and the refinement's GCC-PHAT) per
measurement call, in the traced calls."""

from benchmark.core.kernels import is_kernel, picker


def read(ctx):
    fft = picker(ctx.kernels, "fft", exclude=("csrc",))
    return 1e3 * ctx.trace.device_seconds(lambda s: is_kernel(s) and fft(s)) / ctx.trace.calls
