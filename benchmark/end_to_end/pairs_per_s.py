"""pairs_per_s: stream pairs measured by the calls that ended inside the
window, per second of the window (pairs/s). Streams one card keeps
measured at a 10 s cadence are ten times this."""


def compute(run) -> float:
    return run.window.rate("pairs")
