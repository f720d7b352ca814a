"""Helpers of the readers of the program's span totals and counters
(`sonido_sonar_tpu_torch/utils/metrics.py`): not a metric itself.

A program without the named spans or counters (a commit before them)
gives a reader no `COUNTERS`, so the harness reads nothing for it and
the reader returns None: the metric is left out of that run's line."""

from benchmark.core import counters as C


def present(counters: dict) -> dict:
    """`counters` if the program has every one of them, else {}."""
    try:
        for where in counters.values():
            C.read(where)
    except AttributeError:
        return {}
    return dict(counters)


def per_call(ctx, names, scale: float = 1.0):
    """The sum of the named counters over the traced calls, times `scale`;
    None where the program lacks them."""
    if not names or any(n not in ctx.counters for n in names):
        return None
    return scale * sum(ctx.counters[n] for n in names) / ctx.trace.calls
