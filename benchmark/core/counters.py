"""The program's exact counters, named in the per-layer metrics that read
them: a reader module's `COUNTERS` maps a name it reads from
`ctx.counters` to "<module>:<attribute path>", an integer attribute of
the program (the kernel wrappers' `.launches`). The harness reads every
counter the cell's metrics name before and after the traced calls, so a
new counter is a new reader file and no driver changes."""

from __future__ import annotations

import importlib
from typing import Dict, Iterable


def read(where: str) -> int:
    """The counter at "<module>:<attr>[.<attr>...]"."""
    module, _, path = where.partition(":")
    obj = importlib.import_module(module)
    for attr in path.split("."):
        obj = getattr(obj, attr)
    return int(obj)


def named(readers: Iterable) -> Dict[str, str]:
    """Every counter the reader modules name, one place per name."""
    out: Dict[str, str] = {}
    for mod in readers:
        for name, where in getattr(mod, "COUNTERS", {}).items():
            if out.setdefault(name, where) != where:
                raise ValueError(f"counter {name!r} is named for two places: {out[name]!r}, {where!r}")
    return out


def snapshot(counters: Dict[str, str]) -> Dict[str, int]:
    return {name: read(where) for name, where in counters.items()}
