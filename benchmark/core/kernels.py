"""Pick trace records by the groups of `layer_metrics/kernels.json`."""

from __future__ import annotations


def picker(groups: dict, *names: str, exclude: tuple = ()):
    """A predicate on trace spans: in any of `names`' groups and in none
    of `exclude`'s."""
    want = [s.lower() for n in names for s in groups[n]]
    skip = [s.lower() for n in exclude for s in groups[n]]

    def pick(span) -> bool:
        name = span.name.lower()
        return any(s in name for s in want) and not any(s in name for s in skip)

    return pick


def is_kernel(span) -> bool:
    return span.cat == "kernel"
