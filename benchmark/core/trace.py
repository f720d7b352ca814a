"""The traced window: a torch.profiler session over a few steady calls,
read back from its Chrome trace.

The session copies the port's workaround for lost kernel records
(`utils/metrics.profiler_trace`, not imported): a warm-up step of 1024
one-element kernels that the schedule drops, then the recorded step,
with 0.1 s of idle device before and after the calls. The trace is
written into a temporary directory under TMPDIR, read, and deleted; a
few steady calls give some tens of MB of JSON.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, List, Tuple

import torch

WARMUP_KERNELS = 1024
MARGIN_S = 0.1
WINDOW_LABEL = "bench_traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


@dataclass
class Span:
    name: str
    cat: str
    ts: float   # microseconds, the trace's clock
    dur: float

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclass
class TraceReading:
    calls: int
    window: Span
    device: List[Span] = field(default_factory=list)
    host: List[Span] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window.dur * 1e-6

    def _clipped(self, spans: List[Span]) -> List[Tuple[float, float]]:
        lo, hi = self.window.ts, self.window.end
        return [(max(s.ts, lo), min(s.end, hi)) for s in spans if s.end > lo and s.ts < hi]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[Tuple[float, float]] = []
        for a, b in sorted(self._clipped(self.device)):
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def device_seconds(self, pick: Callable[[Span], bool]) -> float:
        return sum(b - a for (a, b), s in zip(self._clipped(self.device), self._inside(self.device))
                   if pick(s)) * 1e-6

    def _inside(self, spans: List[Span]) -> List[Span]:
        lo, hi = self.window.ts, self.window.end
        return [s for s in spans if s.end > lo and s.ts < hi]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the host operation that overlaps each the most."""
        by_name: dict = {}
        for (a, b), s in zip(self._clipped(self.device), self._inside(self.device)):
            by_name[s.name] = by_name.get(s.name, 0.0) + (b - a) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        edges = [self.window.ts] + [x for ab in busy for x in ab] + [self.window.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        named = []
        for a, b in gaps:
            best, best_key = None, None
            for h in self.host:
                ov = min(h.end, b) - max(h.ts, a)
                if ov > 0 and (best_key is None or (ov, -h.dur) > best_key):
                    best, best_key = h.name, (ov, -h.dur)
            if best is None:   # the host ran Python between operators: name the last one
                before = [h for h in self.host if h.ts <= a]
                best = "host after " + (max(before, key=lambda h: h.ts).name if before else "start")
            named.append([best[:160], (b - a) * 1e-6])
        return {"device_ops": [[n[:160], v] for n, v in ops], "idle_gaps": named}


def traced(run_calls: Callable[[], int]) -> TraceReading:
    """Run `run_calls()` (it makes the calls, waits for the device and
    returns how many it made) under the profiler and read the trace."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="bench_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        with torch.profiler.profile(
            activities=acts,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(path),
        ) as prof:
            buf = torch.zeros(1, device="cuda")
            for _ in range(WARMUP_KERNELS):
                buf.add_(1.0)
            torch.cuda.synchronize()
            prof.step()
            time.sleep(MARGIN_S)
            with torch.profiler.record_function(WINDOW_LABEL):
                calls = run_calls()
                torch.cuda.synchronize()
            time.sleep(MARGIN_S)
            prof.step()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return read_events(events, calls)


def read_events(events: list, calls: int) -> TraceReading:
    window, device, host = None, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        s = Span(str(e.get("name", "")), str(e.get("cat", "")), float(e["ts"]), float(e.get("dur", 0.0)))
        if s.cat == "user_annotation" and s.name == WINDOW_LABEL:
            window = s
        elif s.cat in DEVICE_CATS:
            device.append(s)
        elif s.cat in HOST_CATS:
            host.append(s)
    if window is None:
        raise RuntimeError("the trace holds no traced window")
    return TraceReading(calls, window, device, host)
