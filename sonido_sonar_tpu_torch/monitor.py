"""Continuous CDN latency monitoring: rolling windows of a source and a
CDN stream, aligned on demand by the batched hybrid aligner.

Counterpart of `sonido_sonar_tpu/monitor.py` (`LatencyMeasurement`,
`LatencyMonitor`, `FleetMonitor`, the rolling windows). The windows are
tensors on the monitor's `device`, updated in place by each push (the
kept part shifts left, the chunk lands at the tail); `measure()` and
`measure_all()` feed them straight into
`ops/stats/batched_alignment.batched_align_audio`, whose banded DTW runs
the CUDA fill and backtrack kernels on a CUDA device.

The windows own their buffers: a push copies the chunk in, so changing
the pushed array afterwards never changes a window. `device` defaults to
the card; the CPU runs only when the caller asks for it (`utils/device.py`).

A push from host memory (numpy, a list, a CPU tensor) into a window on
the card goes through pinned memory: the host copies the chunk's last W
samples into a pinned float32 buffer (converting the dtype in the same
pass), then enqueues one non-blocking upload on the device's current
stream. The buffer comes from torch's caching host allocator, which
hands it out again only once the upload that reads it has completed;
the caller's array is copied before `push` returns, and never pinned or
kept. The window's shift and the upload are enqueued on the same stream,
so `measure` follows them in stream order with no host wait.

Spans (`utils/metrics.Span`, recorded while a profiler session runs):
`monitor.measure` around each `measure` / `measure_all` call,
`monitor.push` around each push, `monitor.stage` around a push's staging
through pinned memory, `monitor.host_copy` around the copy of a
measurement batch's outputs to the host. Each push from host memory into
a CPU window (a blocking copy), sub-batch index upload and output copied
adds one to `utils/metrics.host_syncs`; a staged push waits on nothing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from sonido_sonar_tpu_torch.config.config import AlignmentConfig, FeatureConfig
from sonido_sonar_tpu_torch.logging import get_global_logger
from sonido_sonar_tpu_torch.utils.device import DEFAULT_DEVICE, Device, as_float32
from sonido_sonar_tpu_torch.utils.metrics import Span, count_host_sync

MEASURE = Span("monitor.measure")
PUSH = Span("monitor.push")
STAGE = Span("monitor.stage")
HOST_COPY = Span("monitor.host_copy")

_METHOD_NAMES = {0: "energy_correlation", 1: "hybrid_correlation", 2: "hybrid_dtw"}


@dataclass
class LatencyMeasurement:
    time_s: float          # stream time at measurement (source samples seen)
    latency_s: float       # positive = CDN behind source
    confidence: float
    similarity: float
    method: str


def _host_tensor(pcm) -> torch.Tensor:
    """`pcm` as a tensor in host memory: a view of a numpy array where
    torch can take one (the staging copy converts its dtype)."""
    if isinstance(pcm, torch.Tensor):
        return pcm
    a = np.asarray(pcm)
    try:
        return torch.from_numpy(a)
    except (TypeError, ValueError):   # a dtype torch lacks, negative strides
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _stage_into(dst: torch.Tensor, x: torch.Tensor) -> None:
    """Write host chunk `x` into `dst`, a window's view on the card of x's
    broadcast shape: one host copy into a pinned float32 buffer, then one
    non-blocking copy on the device's current stream (torch uploads into a
    contiguous device block and copies that into a strided `dst`)."""
    with STAGE:
        pinned = torch.empty(dst.shape, dtype=torch.float32, pin_memory=True)
        pinned.copy_(x.expand(dst.shape))    # torch's copy runs on every host core
        dst.copy_(pinned, non_blocking=True)


class _RollingWindow:
    """Rolling PCM window of one stream side: [W], or [N, W] for a fleet."""

    def __init__(self, window: int, n_streams: int = 0, device: Device = DEFAULT_DEVICE):
        self.window = window
        self.shape = (window,) if n_streams == 0 else (n_streams, window)
        self.device = torch.device(device)
        self.buf: Optional[torch.Tensor] = None  # allocated at the first push
        self.filled = np.zeros(self.shape[:-1], dtype=np.int64)  # samples pushed, per row

    def _ensure(self) -> torch.Tensor:
        if self.buf is None:
            self.buf = torch.zeros(self.shape, dtype=torch.float32, device=self.device)
        return self.buf

    def push(self, pcm, row: Optional[int] = None) -> int:
        """Append a chunk: to row `row` of a fleet buffer, or to every row
        ([N, L], or one [L] chunk for all) when row is None. Returns the
        chunk length."""
        with PUSH:
            on_card = isinstance(pcm, torch.Tensor) and pcm.is_cuda
            staged = self.device.type == "cuda" and not on_card
            x = _host_tensor(pcm) if staged else as_float32(pcm, self.device)
            n = int(x.shape[-1])
            if n == 0:
                return 0
            if not (staged or on_card):
                count_host_sync()   # a blocking copy from host memory
            buf = self._ensure()
            dst = buf if row is None else buf[row]
            w = self.window
            if n < w:   # the shift, enqueued before the tail is written
                kept = dst[..., n:].clone()
                dst[..., : w - n].copy_(kept)
            tail, x = dst[..., w - min(n, w):], x[..., -w:]
            if staged:
                _stage_into(tail, x)
            else:
                tail.copy_(x.to(self.device).expand(tail.shape))
        if row is None:
            self.filled += n
        else:
            self.filled[row] += n
        return n

    def ready(self, row: Optional[int] = None) -> bool:
        f = self.filled if row is None else self.filled[row]
        return bool(np.all(f >= self.window))

    def ready_mask(self) -> np.ndarray:
        return self.filled >= self.window


def _host(out: dict) -> dict:
    """One device-to-host copy per output of a measurement batch."""
    with HOST_COPY:
        count_host_sync(len(out))
        return {k: v.cpu() for k, v in out.items()}


@dataclass
class LatencyMonitor:
    """Rolling-window latency monitor for a (source, cdn) stream pair.

    window_seconds of audio per stream are kept on `device`; every
    measure() aligns the windows with the batched hybrid pipeline at B=1
    (the policy and offsets of AlignmentExtractor.align_audio_files).
    """

    feature_config: FeatureConfig
    alignment_config: AlignmentConfig = field(default_factory=AlignmentConfig)
    window_seconds: float = 60.0
    max_lag_seconds: float = 30.0
    device: Device = DEFAULT_DEVICE

    def __post_init__(self) -> None:
        self.device = torch.device(self.device)
        self._sr = self.feature_config.sample_rate
        n = int(self.window_seconds * self._sr)
        self._window = n
        self._src = _RollingWindow(n, device=self.device)
        self._cdn = _RollingWindow(n, device=self.device)
        self._samples_seen = 0
        self._max_offset = self._refine_budget(n)
        self.history: List[LatencyMeasurement] = []
        self._log = get_global_logger().with_component("latency_monitor")

    def _refine_budget(self, window: int) -> int:
        """|offset| bound of the PHAT verify/refine windows: the lag budget
        plus 32 hops, leaving at least a quarter of the window."""
        return min(int(self.max_lag_seconds * self._sr) + 32 * self.feature_config.hop_size,
                   3 * window // 4)

    def push_source(self, pcm) -> None:
        self._samples_seen += self._src.push(pcm)

    def push_cdn(self, pcm) -> None:
        self._cdn.push(pcm)

    def ready(self) -> bool:
        """Both rolling windows full."""
        return self._src.ready() and self._cdn.ready()

    def measure(self, refine: bool = False) -> Optional[LatencyMeasurement]:
        """Align the current windows; None until enough audio is buffered.
        refine=True sharpens the offset to the sample by GCC-PHAT."""
        if not self.ready():
            return None
        from sonido_sonar_tpu_torch.ops.stats.batched_alignment import batched_align_audio

        with MEASURE:
            out = _host(batched_align_audio(
                self._src.buf[None], self._cdn.buf[None], self._sr,
                window_size=self.feature_config.window_size,
                hop_size=self.feature_config.hop_size, max_lag_seconds=self.max_lag_seconds,
                refine=refine, max_offset_samples=self._max_offset,
            ))
        m = self._to_measurement(out, 0, self._samples_seen / self._sr, refine)
        self.history.append(m)
        return m

    @staticmethod
    def _to_measurement(out: dict, i: int, time_s: float, refine: bool) -> LatencyMeasurement:
        offset = float(out["offset_seconds_refined"][i] if refine else out["offset_seconds"][i])
        method = _METHOD_NAMES[int(out["method"][i])]
        if bool(out["verified"][i]):
            method += "+verify"
        if refine:
            method += "+phat"
        return LatencyMeasurement(time_s=float(time_s), latency_s=offset,
                                  confidence=float(out["confidence"][i]),
                                  similarity=float(out["similarity"][i]), method=method)

    def current_latency(self) -> Optional[float]:
        """Median of the recent measurements that clear min_confidence."""
        recent = [m for m in self.history[-10:]
                  if m.confidence >= self.alignment_config.min_confidence]
        if not recent:
            return self.history[-1].latency_s if self.history else None
        return float(np.median([m.latency_s for m in recent]))

    def stats(self) -> dict:
        """Offset statistics across history (AlignmentStats shape)."""
        from sonido_sonar_tpu_torch.ops.stats.alignment import offset_stats

        return offset_stats([m.latency_s for m in self.history])


@dataclass
class FleetMonitor:
    """Latency monitoring for N (source, cdn) stream pairs on one device:
    [N, W] rolling windows per side, per-stream or fleet-wide pushes, and
    `measure_all()` — one batched hybrid alignment (+ GCC-PHAT refinement)
    over the ready streams, in sub-batches of `measure_batch`."""

    feature_config: FeatureConfig
    n_streams: int = 16
    alignment_config: AlignmentConfig = field(default_factory=AlignmentConfig)
    window_seconds: float = 60.0
    max_lag_seconds: float = 30.0
    measure_batch: int = 32
    device: Device = DEFAULT_DEVICE

    def __post_init__(self) -> None:
        self.device = torch.device(self.device)
        self._sr = self.feature_config.sample_rate
        n = int(self.window_seconds * self._sr)
        self._window = n
        self._src = _RollingWindow(n, self.n_streams, self.device)
        self._cdn = _RollingWindow(n, self.n_streams, self.device)
        self._samples_seen = np.zeros(self.n_streams, dtype=np.int64)
        self._max_offset = min(int(self.max_lag_seconds * self._sr)
                               + 32 * self.feature_config.hop_size, 3 * n // 4)
        self.history: List[List[LatencyMeasurement]] = [[] for _ in range(self.n_streams)]
        self._log = get_global_logger().with_component("fleet_monitor")

    def push_source(self, stream: int, pcm) -> None:
        self._samples_seen[stream] += self._src.push(pcm, row=stream)

    def push_cdn(self, stream: int, pcm) -> None:
        self._cdn.push(pcm, row=stream)

    def push_source_all(self, chunks) -> None:
        """One [N, L] (or broadcast [L]) chunk for every stream."""
        self._samples_seen += self._src.push(chunks)

    def push_cdn_all(self, chunks) -> None:
        self._cdn.push(chunks)

    def ready_mask(self) -> np.ndarray:
        return self._src.ready_mask() & self._cdn.ready_mask()

    def measure_all(self, refine: bool = True) -> List[Optional[LatencyMeasurement]]:
        """Align every ready stream pair, sub-batched by `measure_batch`
        (a short tail is padded by repeating its first row, so every
        sub-batch has one shape). Returns per-stream measurements (None
        where the windows are not full) and appends to the histories."""
        ready = self.ready_mask()
        results: List[Optional[LatencyMeasurement]] = [None] * self.n_streams
        idxs = np.nonzero(ready)[0]
        if idxs.size == 0:
            return results
        from sonido_sonar_tpu_torch.ops.stats.batched_alignment import batched_align_audio

        mb = min(self.measure_batch, self.n_streams)
        with MEASURE:
            for lo in range(0, idxs.size, mb):
                sub = idxs[lo: lo + mb]
                take = np.concatenate([sub, np.repeat(sub[:1], mb - sub.size)])
                count_host_sync()   # a blocking copy from host memory
                rows = torch.from_numpy(take).to(self._src.buf.device)
                out = _host(batched_align_audio(
                    self._src.buf[rows], self._cdn.buf[rows], self._sr,
                    window_size=self.feature_config.window_size,
                    hop_size=self.feature_config.hop_size, max_lag_seconds=self.max_lag_seconds,
                    refine=refine, max_offset_samples=self._max_offset,
                ))
                for pos, i in enumerate(sub):
                    m = LatencyMonitor._to_measurement(out, pos, self._samples_seen[i] / self._sr,
                                                       refine)
                    results[i] = m
                    self.history[i].append(m)
        return results

    def current_latency(self, stream: int) -> Optional[float]:
        recent = [m for m in self.history[stream][-10:]
                  if m.confidence >= self.alignment_config.min_confidence]
        if not recent:
            h = self.history[stream]
            return h[-1].latency_s if h else None
        return float(np.median([m.latency_s for m in recent]))

    def stats(self, stream: int) -> dict:
        from sonido_sonar_tpu_torch.ops.stats.alignment import offset_stats

        return offset_stats([m.latency_s for m in self.history[stream]])
