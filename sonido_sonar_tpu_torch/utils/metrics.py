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


@contextlib.contextmanager
def profiler_trace(log_dir: str) -> Iterator[None]:
    """torch.profiler trace context: the host's operators and, where a
    card is present, its kernels, written as a Chrome trace
    (`<host>_<pid>.<ns>.pt.trace.json`) into `log_dir` on exit. On a card
    the device is synchronized before the trace starts and before it
    stops, so the trace holds the block's device work, all of it."""
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
