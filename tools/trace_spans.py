#!/usr/bin/env python3
"""Where the benchmark cells' idle device time sits among the port's spans,
and what the spans cost.

    python3 tools/trace_spans.py --cells monitor.mixed-64,backfill.stream-30s \
        --seed 4100000001 [--calls 5] [--rate-calls 20] [--out chiprun_out/trace_spans.json]

Needs a CUDA card. For each cell it builds the cell's benchmark driver
(`benchmark/drivers/`, traffic from the seed), times `--rate-calls`
calls with the profiler off (calls a second), then traces `--calls` calls
under `utils/metrics.profiler_trace` inside a `bench_traced_window`
annotation that ends with `torch.cuda.synchronize()`, as the benchmark's
traced window does (`benchmark/core/trace.py`). From the Chrome trace it
reports the ten longest idle gaps of the device inside the window, each
with the host operator the benchmark would name it by and the innermost
program span over it (the span overlapping the gap the most, the
shortest of those that overlap it equally; `outside every span` where
none does), the traced calls a second, and each span's count and host
ms a call from its totals, and the device's idle ms a call under each
innermost span, over every gap of the window. Once per run it times a span's enter and
exit with the profiler off and on, and `count_host_sync`. Prints one
JSON line per cell and writes them all to `--out`.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.core import spec as S  # noqa: E402
from chip_smoke import card_line  # noqa: E402
from benchmark.core import trace as T  # noqa: E402
from sonido_sonar_tpu_torch import monitor  # noqa: E402
from sonido_sonar_tpu_torch.fingerprint import content_detector, generator  # noqa: E402
from sonido_sonar_tpu_torch.ops.stats import batched_alignment  # noqa: E402
from sonido_sonar_tpu_torch.parallel import pipeline  # noqa: E402
from sonido_sonar_tpu_torch.utils import metrics  # noqa: E402
from sonido_sonar_tpu_torch.utils.metrics import Span, profiler_trace  # noqa: E402

SPANS = [v for mod in (monitor, batched_alignment, pipeline, generator, content_detector)
         for v in vars(mod).values() if isinstance(v, Span)]


def span_cost_ns(n_off: int = 1_000_000, n_on: int = 100_000) -> dict:
    """ns of one `with span: pass` beyond an empty loop, off and under a
    profiler session (CPU and CUDA activities), beside a context manager
    that does nothing; ns of one count_host_sync."""
    span = Span("cost.probe")
    null = contextlib.nullcontext()

    def loop(n, body):
        t0 = time.perf_counter_ns()
        body(n)
        return (time.perf_counter_ns() - t0) / n

    def empty(n):
        for _ in range(n):
            pass

    def spans(n):
        for _ in range(n):
            with span:
                pass

    def nulls(n):
        for _ in range(n):
            with null:
                pass

    def ticks(n):
        for _ in range(n):
            metrics.count_host_sync()

    before = metrics.host_syncs
    base = min(loop(n_off, empty) for _ in range(3))
    off = min(loop(n_off, spans) for _ in range(3)) - base
    nothing = min(loop(n_off, nulls) for _ in range(3)) - base
    tick = min(loop(n_off, ticks) for _ in range(3)) - base
    metrics.host_syncs = before
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        base_on = min(loop(n_on, empty) for _ in range(3))
        on = min(loop(n_on, spans) for _ in range(3)) - base_on
    return {"off_ns": off, "on_ns": on, "null_context_ns": nothing, "count_host_sync_ns": tick}


def _events(log_dir: str) -> list:
    files = sorted(glob.glob(os.path.join(log_dir, "*.pt.trace.json")), key=os.path.getmtime)
    with open(files[-1]) as f:
        return json.load(f)["traceEvents"]


def _spans_in(events: list, lo: float, hi: float) -> list:
    names = {s.name for s in SPANS}
    return [T.Span(e["name"], e["cat"], float(e["ts"]), float(e.get("dur", 0.0))) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") in names
            and float(e["ts"]) < hi and float(e["ts"]) + float(e.get("dur", 0.0)) > lo]


def _over(spans: list, a: float, b: float):
    best, key = None, None
    for s in spans:
        ov = min(s.end, b) - max(s.ts, a)
        if ov > 0 and (key is None or (ov, -s.dur) > key):
            best, key = s, (ov, -s.dur)
    return best


def innermost(spans: list, a: float, b: float) -> dict:
    """ms of [a, b] under each innermost span: at each instant the
    shortest span open there, or `outside every span`."""
    over = [s for s in spans if s.end > a and s.ts < b]
    cuts = sorted({a, b} | {x for s in over for x in (s.ts, s.end) if a < x < b})
    split: dict = {}
    for lo, hi in zip(cuts, cuts[1:]):
        mid = (lo + hi) / 2
        cover = [s for s in over if s.ts <= mid < s.end]
        name = min(cover, key=lambda s: s.dur).name if cover else "outside every span"
        split[name] = split.get(name, 0.0) + (hi - lo) * 1e-3
    return split


def idle_intervals(reading: T.TraceReading) -> list:
    busy = reading.busy_intervals()
    edges = [reading.window.ts] + [x for ab in busy for x in ab] + [reading.window.end]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]


def gaps(reading: T.TraceReading, spans: list, top: int = 10) -> list:
    """The `top` longest idle gaps of the device in the window, each with
    the host operator the benchmark names it by and the innermost span
    over most of it."""
    out = []
    for a, b in sorted(idle_intervals(reading), key=lambda g: g[0] - g[1])[:top]:
        host = _over(reading.host, a, b)
        split = innermost(spans, a, b)
        out.append({"ms": (b - a) * 1e-3, "at_ms": (a - reading.window.ts) * 1e-3,
                    "host_op": host.name[:80] if host else "host between operators",
                    "span": max(split, key=split.get), "split_ms": split})
    return out


def trace_cell(cell: S.Cell, seed: int, calls: int, rate_calls: int, device="cuda") -> dict:
    driver = S.load_module("drivers", cell.config["driver"]).Driver(
        cell.config, cell.traffic, cell.check, seed, device)
    driver.run_calls(5)   # past the first stream's pinned allocations
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    driver.run_calls(rate_calls)
    torch.cuda.synchronize()
    untraced = rate_calls / (time.perf_counter() - t0)
    totals = {s.name: (s.count, s.total_ns) for s in SPANS}
    syncs = metrics.host_syncs
    with tempfile.TemporaryDirectory(prefix="trace_spans_") as tmp:
        with profiler_trace(tmp):
            with torch.profiler.record_function(T.WINDOW_LABEL):
                n = driver.run_calls(calls)
                torch.cuda.synchronize()
        events = _events(tmp)
    reading = T.read_events(events, n)
    spans = _spans_in(events, reading.window.ts, reading.window.end)
    per_call = {s.name: {"count": (s.count - totals[s.name][0]) / n,
                         "ms": (s.total_ns - totals[s.name][1]) * 1e-6 / n}
                for s in SPANS if s.count > totals[s.name][0]}
    idle: dict = {}
    for a, b in idle_intervals(reading):
        for name, ms in innermost(spans, a, b).items():
            idle[name] = idle.get(name, 0.0) + ms / n
    device_syncs = [h for h in reading.host if h.name == "cudaDeviceSynchronize"
                    and reading.window.ts <= h.ts <= reading.window.end]
    return {
        "cell": cell.name, "seed": seed, "calls": n,
        "calls_per_s_untraced": untraced, "calls_per_s_traced": n / reading.window_s,
        "window_ms": reading.window_s * 1e3, "busy_pct": 100 * reading.busy_s / reading.window_s,
        "host_syncs_per_call": (metrics.host_syncs - syncs) / n,
        "spans_per_call": sum(v["count"] for v in per_call.values()),
        "span_totals_per_call": per_call,
        "device_synchronize_calls": [
            {"at_ms": (h.ts - reading.window.ts) * 1e-3, "ms": h.dur * 1e-3,
             "span": getattr(_over(spans, h.ts, h.end), "name", "outside every span")}
            for h in device_syncs],
        "idle_ms_per_call_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "idle_gaps": gaps(reading, spans),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cells", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--calls", type=int, default=5)
    p.add_argument("--rate-calls", type=int, default=20)
    p.add_argument("--out", default="chiprun_out/trace_spans.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    lines = [{"card": card_line(), "span_cost": span_cost_ns()}]
    print(json.dumps(lines[0]), flush=True)
    for i, name in enumerate(args.cells.split(",")):
        lines.append(trace_cell(S.Cell(name), args.seed + i, args.calls, args.rate_calls))
        print(json.dumps(lines[-1]), flush=True)
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
