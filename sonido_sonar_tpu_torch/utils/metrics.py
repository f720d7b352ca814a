"""Spans and counters inside the port, and the profiler trace they land in.

A `Span` is declared once, where its work happens, as a module-level
object (`PUSH = Span("monitor.push")` in `monitor.py`, used as
`with PUSH:`), as the kernel wrappers keep their `.launches`. It is on
exactly while a `torch.profiler` session records: then it enters
`torch.profiler.record_function(name)`, so it lands in the profiler's
Chrome trace as a `user_annotation` on the kernels' clock, nested under
the span that caused it, and it adds to its integer totals `count` and
`total_ns` (host nanoseconds). Off, entering and leaving it checks one
flag each and does nothing else. Under a `torch.profiler.schedule` the
session records only in its active steps, so the totals cover the
traced calls alone. No span stays open across a `yield`.

`host_syncs` counts, always, the sites on the monitor's and the
generator's paths where the host waits for the card: a push or an index
upload from host memory, a read of a device flag, a copy of an output to
the host (the content detector's features, each feature tensor that
`FingerprintBatch.materialize` pulls). It counts the site, not the
device, so a CPU run counts what a card run does.

`Metrics` times an entry point's stages on the host clock with the same
spans, always (`examples/cdn_latency.py` reports them); `profiler_trace`
writes the trace the spans are read in. Counterpart of
`sonido_sonar_tpu/utils/metrics.py` (`Metrics.timer`, `snapshot`,
`profiler_trace`).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator

import torch
import torch.autograd.profiler as _profiler

host_syncs = 0


def count_host_sync(n: int = 1) -> None:
    """Add `n` sites where the host waits for the card to `host_syncs`."""
    global host_syncs
    host_syncs += n


class Span:
    """A named interval of the port's work; see the module docstring."""

    __slots__ = ("name", "count", "total_ns", "_open", "_local", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self.count = 0
        self.total_ns = 0
        self._open = 0                  # entries not yet left, all threads
        self._local = threading.local()
        self._lock = threading.Lock()

    def __enter__(self) -> "Span":
        if _profiler._is_profiler_enabled:
            self._begin(annotate=True)
        return self

    def __exit__(self, *exc) -> None:
        if self._open:
            self._end()

    def _begin(self, annotate: bool) -> None:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        rf = None
        if annotate:
            rf = torch.profiler.record_function(self.name)
            rf.__enter__()
        stack.append((rf, time.perf_counter_ns()))
        with self._lock:
            self._open += 1

    def _end(self) -> None:
        stack = getattr(self._local, "stack", None)
        if not stack:                   # entered while the profiler was off
            return
        rf, t0 = stack.pop()
        elapsed = time.perf_counter_ns() - t0
        with self._lock:
            self._open -= 1
            self.count += 1
            self.total_ns += elapsed
        if rf is not None:
            rf.__exit__(None, None, None)


class Metrics:
    """Stage timers of one entry point: a span per stage, timed whether or
    not a profiler records (and annotated in its trace when one does)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._spans: Dict[str, Span] = {}

    @contextlib.contextmanager
    def timer(self, stage: str, block_on=None) -> Iterator[None]:
        """Wall-clock a stage; `block_on` (a tensor or a device) on CUDA
        makes the stage include device completion."""
        with self._lock:
            span = self._spans.setdefault(stage, Span(stage))
        span._begin(annotate=_profiler._is_profiler_enabled)
        try:
            yield
        finally:
            if block_on is not None:
                dev = block_on.device if isinstance(block_on, torch.Tensor) else torch.device(block_on)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            span._end()

    def snapshot(self) -> dict:
        with self._lock:
            spans = list(self._spans.values())
        return {"stages": {s.name: {"calls": s.count, "total_s": s.total_ns * 1e-9,
                                    "mean_ms": s.total_ns * 1e-6 / s.count if s.count else 0.0}
                           for s in spans}}


# profiler_trace on a card: the one-element kernels of its warm-up step,
# and the idle seconds it leaves between the recorded step's start and
# the block, and between the block and the step's end
WARMUP_KERNELS = 1024
TRACE_MARGIN_S = 0.1


@contextlib.contextmanager
def profiler_trace(log_dir: str) -> Iterator[None]:
    """torch.profiler trace context: the host's operators and the port's
    spans and, where a card is present, its kernels, written as a Chrome
    trace (`<host>_<pid>.<ns>.pt.trace.json`) into `log_dir` on exit.

    The session runs under a `torch.profiler.schedule` of one warm-up
    step, whose records the schedule drops, and one recorded step that
    holds the block. On a card the warm-up step launches WARMUP_KERNELS
    one-element kernels and synchronizes, and the recorded step leaves
    the card idle for TRACE_MARGIN_S seconds before and after the block.
    On an H100, a trace taken late in a long process (minutes of device
    work) lost kernel records at its start in two ways, both while every
    launch call was kept. (1) The session's first ~20-25 kernel records
    went missing (22-29 of one main-path step's 211, K1's among them),
    whatever idle time came before them; kernels in a warm-up step take
    that loss. (2) The device records' clock was offset from the host's
    by up to ~5 ms (a kernel stamped before its own launch call), so a
    kernel that ran within that offset of the recorded step's start fell
    outside it; the idle margin, ~20x the largest offset seen, keeps the
    block clear of that. Why either happens (in kineto or CUPTI) is not
    known, and a larger offset would still lose records: `chip_smoke.py`
    phase 36 traces a step several times in its long process, and once
    in a fresh one, and holds each trace's kernel records to its own
    launch calls."""
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
        activities=activities,
        schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1),
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        if cuda:
            buf = torch.zeros(1, device="cuda")
            for _ in range(WARMUP_KERNELS):
                buf.add_(1.0)
            torch.cuda.synchronize()
        prof.step()
        if cuda:
            time.sleep(TRACE_MARGIN_S)
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
                time.sleep(TRACE_MARGIN_S)
            prof.step()
