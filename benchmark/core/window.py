"""The measured window: its calls on the host clock, and the arithmetic
of rates and percentiles over them.

A call is one unit of closed-loop work (a fleet measurement, a batch of
clips) with its start, its end and what it completed. A rate counts the
work of every call that ended inside the window over the window's whole
length; a percentile is over every call the window started, the one that
ran past its end included.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List


@dataclass
class Call:
    start: float
    end: float
    units: Dict[str, float]
    failed: bool = False


@dataclass
class Window:
    t0: float
    seconds: float
    calls: List[Call] = field(default_factory=list)

    @property
    def t_end(self) -> float:
        return self.t0 + self.seconds

    def completed(self) -> List[Call]:
        return [c for c in self.calls if c.end <= self.t_end and not c.failed]

    def rate(self, unit: str) -> float:
        """Units of the calls completed inside the window, per second of it."""
        return sum(c.units.get(unit, 0.0) for c in self.completed()) / self.seconds

    def latencies_s(self) -> List[float]:
        return [c.end - c.start for c in self.calls]

    @property
    def attempted(self) -> int:
        return len(self.calls)

    @property
    def failed(self) -> int:
        return sum(c.failed for c in self.calls)


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile, linear between order statistics (numpy's
    default, Python's `statistics.quantiles(method="inclusive")`)."""
    if not values:
        raise ValueError("percentile of no values")
    s = sorted(values)
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def closed_loop(call: Callable[[], tuple], seconds: float,
                clock: Callable[[], float] = time.perf_counter) -> Window:
    """Call `call()` back to back until the window's end: each returns
    (units dict, failed bool) once its results are on the host. The call
    running when the window closes is finished and recorded."""
    win = Window(clock(), float(seconds))
    while True:
        start = clock()
        if start >= win.t_end:
            return win
        units, failed = call()
        win.calls.append(Call(start, clock(), units, failed))
