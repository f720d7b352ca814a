"""Lightweight observability: counters and stage timers.

Counterpart of `sonido_sonar_tpu/utils/metrics.py` (`Metrics.count`,
`timer`, `record_audio`, `snapshot`, `reset`, `get_global_metrics`).
`timer(block_on=...)` takes a tensor or a device: on a CUDA device the
stage ends with `torch.cuda.synchronize`, so device work counts.
`profiler_trace(log_dir)` is JAX's `jax.profiler` trace context on
`torch.profiler`.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


class Metrics:
    """Thread-safe counters + timing accumulators."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)
        self._timings: Dict[str, list] = defaultdict(list)

    def count(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    @contextlib.contextmanager
    def timer(self, stage: str, block_on=None) -> Iterator[None]:
        """Wall-clock a stage; `block_on` (a tensor or a device) on CUDA
        makes the stage include device completion."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                dev = block_on.device if isinstance(block_on, torch.Tensor) else torch.device(block_on)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            with self._lock:
                self._timings[stage].append(time.perf_counter() - t0)

    def record_audio(self, seconds: float, frames: int = 0) -> None:
        self.count("audio_seconds", seconds)
        self.count("frames", frames)

    def snapshot(self) -> dict:
        with self._lock:
            out = {"counters": dict(self._counters), "stages": {}}
            for stage, ts in self._timings.items():
                total = sum(ts)
                out["stages"][stage] = {
                    "calls": len(ts),
                    "total_s": total,
                    "mean_ms": total / len(ts) * 1000 if ts else 0.0,
                }
            audio_s = self._counters.get("audio_seconds", 0.0)
            wall = sum(sum(ts) for ts in self._timings.values())
            if wall > 0 and audio_s > 0:
                out["throughput_audio_hours_per_hour"] = audio_s / wall
            if wall > 0 and self._counters.get("frames"):
                out["frames_per_sec"] = self._counters["frames"] / wall
            return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timings.clear()


_global = Metrics()


def get_global_metrics() -> Metrics:
    return _global


# profiler_trace on a card: the one-element kernels of its warm-up step,
# and the idle seconds it leaves between the recorded step's start and
# the block, and between the block and the step's end
WARMUP_KERNELS = 1024
TRACE_MARGIN_S = 0.1


@contextlib.contextmanager
def profiler_trace(log_dir: str) -> Iterator[None]:
    """torch.profiler trace context: the host's operators and, where a
    card is present, its kernels, written as a Chrome trace
    (`<host>_<pid>.<ns>.pt.trace.json`) into `log_dir` on exit.

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
