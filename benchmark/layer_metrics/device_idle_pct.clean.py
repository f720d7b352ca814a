"""device_idle_pct.clean: the share of the traced window (a few steady
measurement calls of the healthy fleet, `monitor.clean-64`) in which no
kernel, copy or memset ran on the card."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
