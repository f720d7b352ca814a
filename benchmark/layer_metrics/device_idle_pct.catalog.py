"""device_idle_pct.catalog: the share of the traced window (a few steady
music catalogue batches) in which no kernel, copy or memset ran on the
card."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
