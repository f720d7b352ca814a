"""Common utilities: normalization, interpolation, buffers, math helpers
(counterpart of `sonido_sonar_tpu/ops/common.py`).

Reference parity: algorithms/common/*.go —
  normalization.go: z-score, min-max, energy (unit L2), peak, RMS,
    quantile, robust (median/MAD), adaptive, dB-target, simplified LUFS
    target (400 ms windows, -0.691 + 10log10(ms), integrated loudness,
    gain to target, :344-409);
  interpolation.go: linear/cubic/Hermite/Lanczos point interpolation,
    resample, bilinear;
  math.go: moving average, median filter, correlation, covariance,
    linear regression, FindPeaks, power-of-two helper;
  buffers.go: CircularBuffer, SlidingWindow, DelayLine, OverlapAddBuffer
    (host-side streaming utilities, numpy as in JAX).

As in JAX: standard deviations divide by N, medians average the middle
pair, quantiles are `stats.moments.sorted_quantiles` (JAX's float32
linear rule; `torch.quantile` refuses more than 2^24 elements), and the
interpolators clip every index into [0, n - 1].
"""

from __future__ import annotations

import numpy as np
import torch

from sonido_sonar_tpu_torch.ops.stats.moments import median, sorted_quantiles

_EPS = 1e-10


# ---------------------------------------------------------------------
# Normalization (normalization.go)
# ---------------------------------------------------------------------

def _std(x: torch.Tensor) -> torch.Tensor:
    return torch.std(x, dim=-1, keepdim=True, correction=0)


def z_score_normalize(x: torch.Tensor) -> torch.Tensor:
    m = torch.mean(x, dim=-1, keepdim=True)
    s = _std(x)
    return torch.where(s > _EPS, (x - m) / torch.clamp_min(s, _EPS), x - m)


def min_max_normalize(x: torch.Tensor) -> torch.Tensor:
    lo = torch.amin(x, dim=-1, keepdim=True)
    hi = torch.amax(x, dim=-1, keepdim=True)
    rng = hi - lo
    return torch.where(rng > _EPS, (x - lo) / torch.clamp_min(rng, _EPS), torch.zeros_like(x))


def energy_normalize(x: torch.Tensor) -> torch.Tensor:
    """Unit L2 norm."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return torch.where(n > _EPS, x / torch.clamp_min(n, _EPS), x)


def peak_normalize(x: torch.Tensor) -> torch.Tensor:
    p = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    return torch.where(p > _EPS, x / torch.clamp_min(p, _EPS), x)


def rms_normalize(x: torch.Tensor, target_rms: float = 1.0) -> torch.Tensor:
    r = torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True))
    return torch.where(r > _EPS, x * (target_rms / torch.clamp_min(r, _EPS)), x)


def quantile_normalize(x: torch.Tensor, low: float = 0.05, high: float = 0.95) -> torch.Tensor:
    lo, hi = sorted_quantiles(x, (low, high), keepdim=True)
    rng = hi - lo
    scaled = torch.where(rng > _EPS, (x - lo) / torch.clamp_min(rng, _EPS), torch.zeros_like(x))
    return torch.clamp(scaled, 0.0, 1.0)


def robust_normalize(x: torch.Tensor) -> torch.Tensor:
    """(x - median) / MAD."""
    med = median(x, keepdim=True)
    mad = median(torch.abs(x - med), keepdim=True)
    return torch.where(mad > _EPS, (x - med) / torch.clamp_min(mad, _EPS), x - med)


def adaptive_normalize(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveNormalize (normalization.go:247-290): robust for
    outlier-heavy signals (kurtosis proxy), z-score otherwise."""
    m = torch.mean(x, dim=-1, keepdim=True)
    s = _std(x)
    z = torch.where(s > _EPS, (x - m) / torch.clamp_min(s, _EPS), x - m)
    kurt = torch.mean(z**4, dim=-1, keepdim=True)
    return torch.where(kurt > 5.0, robust_normalize(x), z)


def normalize_db(x: torch.Tensor, target_db: float) -> torch.Tensor:
    """Scale so RMS hits target dBFS (normalization.go:317-341)."""
    r = torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True))
    cur_db = 20.0 * torch.log10(torch.clamp_min(r, _EPS))
    gain = 10.0 ** ((target_db - cur_db) / 20.0)
    return torch.where(r > _EPS, x * gain, x)


def normalize_lufs(x: torch.Tensor, target_lufs: float, sample_rate: int) -> torch.Tensor:
    """Simplified LUFS-target normalization (normalization.go:344-409):
    400 ms / 25% hop momentary loudness -0.691 + 10log10(ms), energy-mean
    integration, then a single linear gain."""
    from sonido_sonar_tpu_torch.ops.framing import num_frames
    from sonido_sonar_tpu_torch.ops.temporal import short_time_energy

    n = x.shape[-1]
    window = min(int(0.4 * sample_rate), n)
    hop = max(window // 4, 1)
    if num_frames(n, window, hop) <= 0:
        return normalize_db(x, target_lufs)
    rms = short_time_energy(x, window, hop)
    valid = rms > _EPS
    loud = -0.691 + 10.0 * torch.log10(torch.clamp_min(rms * rms, _EPS))
    lin = torch.where(valid, 10.0 ** (loud / 10.0), 0.0)
    cnt = torch.sum(valid, dim=-1)
    integrated = -0.691 + 10.0 * torch.log10(
        torch.clamp_min(torch.sum(lin, dim=-1) / torch.clamp_min(cnt, 1), _EPS)
    )
    gain = 10.0 ** ((target_lufs - integrated) / 20.0)
    return torch.where(cnt[..., None] > 0, x * gain[..., None], x)


_NORMALIZERS = {
    "zscore": z_score_normalize,
    "minmax": min_max_normalize,
    "energy": energy_normalize,
    "peak": peak_normalize,
    "rms": rms_normalize,
    "quantile": quantile_normalize,
    "robust": robust_normalize,
    "adaptive": adaptive_normalize,
}


def normalize(x: torch.Tensor, method: str = "zscore") -> torch.Tensor:
    """Normalizer.Normalize (normalization.go:33-53)."""
    fn = _NORMALIZERS.get(method)
    if fn is None:
        raise ValueError(f"unknown normalization {method}")
    return fn(x)


# ---------------------------------------------------------------------
# Interpolation (interpolation.go)
# ---------------------------------------------------------------------

def _floor_index(index: torch.Tensor, n: int) -> torch.Tensor:
    """int32(floor(index)) clipped to [0, n - 1], as a gather index."""
    return torch.clamp(torch.floor(index).to(torch.int32), 0, n - 1).to(torch.int64)


def interp_linear(data: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Linear interpolation at float32 `index` over the last axis. The
    weight is taken from the clipped index, so below 0 and above n - 1
    it extrapolates from the end pair, as JAX does."""
    n = data.shape[-1]
    i0 = _floor_index(index, n)
    i1 = torch.clamp(i0 + 1, 0, n - 1)
    t = index - i0.to(torch.float32)
    return data[..., i0] * (1 - t) + data[..., i1] * t


def _four_points(data: torch.Tensor, index: torch.Tensor):
    n = data.shape[-1]
    i1 = _floor_index(index, n)
    i0 = torch.clamp(i1 - 1, 0, n - 1)
    i2 = torch.clamp(i1 + 1, 0, n - 1)
    i3 = torch.clamp(i1 + 2, 0, n - 1)
    t = index - torch.floor(index)
    return data[..., i0], data[..., i1], data[..., i2], data[..., i3], t


def interp_cubic(data: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Catmull-Rom-style 4-point cubic (interpolation.go:69-105); the
    weight comes from floor(index), unclipped."""
    p0, p1, p2, p3, t = _four_points(data, index)
    a = -0.5 * p0 + 1.5 * p1 - 1.5 * p2 + 0.5 * p3
    b = p0 - 2.5 * p1 + 2.0 * p2 - 0.5 * p3
    c = -0.5 * p0 + 0.5 * p2
    return ((a * t + b) * t + c) * t + p1


def interp_hermite(data: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """4-point Hermite with finite-difference tangents
    (interpolation.go:107-150)."""
    p0, p1, p2, p3, t = _four_points(data, index)
    m1 = 0.5 * (p2 - p0)
    m2 = 0.5 * (p3 - p1)
    t2 = t * t
    t3 = t2 * t
    return (
        (2 * t3 - 3 * t2 + 1) * p1
        + (t3 - 2 * t2 + t) * m1
        + (-2 * t3 + 3 * t2) * p2
        + (t3 - t2) * m2
    )


def _lanczos_kernel(x: torch.Tensor, a: float) -> torch.Tensor:
    px = torch.pi * x
    small = torch.abs(x) < _EPS
    sinc = torch.where(small, 1.0, torch.sin(px) / px)
    sinc_a = torch.where(small, 1.0, torch.sin(px / a) / (px / a))
    return torch.where(torch.abs(x) < a, sinc * sinc_a, 0.0)


def interp_lanczos(data: torch.Tensor, index: torch.Tensor, a: int = 3) -> torch.Tensor:
    """Lanczos-a interpolation (interpolation.go:152-193)."""
    n = data.shape[-1]
    base = torch.floor(index).to(torch.int32)
    total = torch.zeros(data.shape[:-1] + index.shape, dtype=torch.float32, device=data.device)
    wsum = torch.zeros_like(index, dtype=torch.float32)
    for k in range(-a + 1, a + 1):
        i = torch.clamp(base + k, 0, n - 1).to(torch.int64)
        w = _lanczos_kernel(index - (base + k).to(torch.float32), float(a))
        total = total + w * data[..., i]
        wsum = wsum + w
    return torch.where(torch.abs(wsum) > _EPS, total / torch.clamp_min(wsum, _EPS), total)


def resample_signal(
    signal: torch.Tensor, original_rate: int, target_rate: int, method: str = "linear"
) -> torch.Tensor:
    """ResampleSignal (interpolation.go:195-216): output sample j reads
    float32(j) * float32(original / target), a float32 product."""
    n = signal.shape[-1]
    n_out = int(round(n * target_rate / original_rate))
    idx = torch.arange(n_out, dtype=torch.float32, device=signal.device) * (original_rate / target_rate)
    fn = {"linear": interp_linear, "cubic": interp_cubic,
          "hermite": interp_hermite, "lanczos": interp_lanczos}[method]
    return fn(signal, idx)


def bilinear_interpolate(grid: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """2-D bilinear (interpolation.go bilinear)."""
    h, w = grid.shape[-2], grid.shape[-1]
    y0 = _floor_index(yi, h)
    x0 = _floor_index(xi, w)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    ty = yi - y0.to(torch.float32)
    tx = xi - x0.to(torch.float32)
    return (
        grid[..., y0, x0] * (1 - ty) * (1 - tx)
        + grid[..., y0, x1] * (1 - ty) * tx
        + grid[..., y1, x0] * ty * (1 - tx)
        + grid[..., y1, x1] * ty * tx
    )


# ---------------------------------------------------------------------
# Math utils (math.go)
# ---------------------------------------------------------------------

def moving_average(x: torch.Tensor, window: int) -> torch.Tensor:
    """Centered moving average, same length, as
    `np.convolve(v, ones(w) / w, mode="same")` (math.go:140-167); the
    shared code is `temporal.smooth_envelope`."""
    from sonido_sonar_tpu_torch.ops.temporal import smooth_envelope

    return smooth_envelope(x, window)


def median_filter(x: torch.Tensor, window: int) -> torch.Tensor:
    """Sliding median, same length, edge padding, the middle pair
    averaged on an even window (math.go:169-209); the shared code is
    `pitch.median_filter_pitch`."""
    from sonido_sonar_tpu_torch.ops.pitch import median_filter_pitch

    return median_filter_pitch(x, window)


def correlation(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pearson correlation (math.go:211-218)."""
    xm = x - torch.mean(x, dim=-1, keepdim=True)
    ym = y - torch.mean(y, dim=-1, keepdim=True)
    num = torch.sum(xm * ym, dim=-1)
    den = torch.sqrt(torch.sum(xm * xm, dim=-1) * torch.sum(ym * ym, dim=-1))
    return torch.where(den > _EPS, num / torch.clamp_min(den, _EPS), 0.0)


def covariance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample covariance (N - 1)."""
    xm = x - torch.mean(x, dim=-1, keepdim=True)
    ym = y - torch.mean(y, dim=-1, keepdim=True)
    n = x.shape[-1]
    return torch.sum(xm * ym, dim=-1) / max(n - 1, 1)


def linear_regression(x: torch.Tensor, y: torch.Tensor):
    """(slope, intercept, r_squared) (math.go:237-263)."""
    mx = torch.mean(x, dim=-1)
    my = torch.mean(y, dim=-1)
    sxy = torch.mean(x * y, dim=-1) - mx * my
    sxx = torch.mean(x * x, dim=-1) - mx * mx
    slope = torch.where(torch.abs(sxx) > _EPS,
                        sxy / torch.clamp_min(torch.abs(sxx), _EPS) * torch.sign(sxx), 0.0)
    intercept = my - slope * mx
    r = correlation(x, y)
    return slope, intercept, r * r


def find_peaks(
    x: torch.Tensor, min_height: float = 0.0, min_distance: int = 1, max_peaks: int = 32
):
    """FindPeaks (math.go:265-303) -> fixed-k (int32 indices, values,
    int32 count) by greedy highest-first suppression: each round takes
    the highest remaining interior local maximum (the first of equal
    ones) and removes every bin within min_distance of it, as
    `harmonic.detect_spectral_peaks` does. Unused slots hold -1 and 0."""
    n = x.shape[-1]
    inner = (x[..., 1:-1] > x[..., :-2]) & (x[..., 1:-1] > x[..., 2:]) & (x[..., 1:-1] >= min_height)
    score = torch.full_like(x, float("-inf"), dtype=torch.float32)
    score[..., 1:-1] = torch.where(inner, x[..., 1:-1].to(torch.float32), float("-inf"))
    dist = max(min_distance, 1)
    offsets = torch.arange(-(dist - 1), dist, device=x.device)
    lead = x.shape[:-1]
    idx = torch.full(lead + (max_peaks,), -1, dtype=torch.int32, device=x.device)
    vals = torch.zeros(lead + (max_peaks,), dtype=torch.float32, device=x.device)
    for i in range(max_peaks):
        best = torch.argmax(score, dim=-1, keepdim=True)
        val = torch.gather(score, -1, best)[..., 0]
        ok = torch.isfinite(val)
        idx[..., i] = torch.where(ok, best[..., 0].to(torch.int32), -1)
        vals[..., i] = torch.where(ok, val, 0.0)
        # clamped offsets stay within min_distance of the peak
        score.scatter_(-1, torch.clamp(best + offsets, 0, n - 1), float("-inf"))
    return idx, vals, torch.sum(idx >= 0, dim=-1, dtype=torch.int32)


def next_power_of_two(n: int) -> int:
    k = 1
    while k < n:
        k <<= 1
    return k


# ---------------------------------------------------------------------
# Host-side streaming buffers (buffers.go)
# ---------------------------------------------------------------------

class CircularBuffer:
    """CircularBuffer (buffers.go:8-105)."""

    def __init__(self, size: int):
        self._buf = np.zeros(size, dtype=np.float32)
        self._size = size
        self._read = 0
        self._count = 0

    def write(self, data: np.ndarray) -> int:
        data = np.asarray(data, dtype=np.float32)
        n = min(len(data), self.space())
        for v in data[:n]:
            self._buf[(self._read + self._count) % self._size] = v
            self._count += 1
        return n

    def read(self, n: int) -> np.ndarray:
        n = min(n, self._count)
        out = np.empty(n, dtype=np.float32)
        for i in range(n):
            out[i] = self._buf[(self._read + i) % self._size]
        self._read = (self._read + n) % self._size
        self._count -= n
        return out

    def peek(self, n: int) -> np.ndarray:
        n = min(n, self._count)
        return np.array(
            [self._buf[(self._read + i) % self._size] for i in range(n)],
            dtype=np.float32,
        )

    def available(self) -> int:
        return self._count

    def space(self) -> int:
        return self._size - self._count

    def clear(self) -> None:
        self._read = 0
        self._count = 0

    @property
    def is_full(self) -> bool:
        return self._count == self._size

    @property
    def is_empty(self) -> bool:
        return self._count == 0


class SlidingWindow:
    """SlidingWindow framer (buffers.go:107-171): push samples, get
    complete [k, window] frames back."""

    def __init__(self, window_size: int, hop_size: int):
        self.window_size = window_size
        self.hop_size = hop_size
        self._buf = np.zeros(0, dtype=np.float32)

    def add_samples(self, samples: np.ndarray) -> np.ndarray:
        self._buf = np.concatenate(
            [self._buf, np.asarray(samples, dtype=np.float32)]
        )
        frames = []
        while len(self._buf) >= self.window_size:
            frames.append(self._buf[: self.window_size].copy())
            self._buf = self._buf[self.hop_size:]
        return np.stack(frames) if frames else np.zeros((0, self.window_size), np.float32)

    def reset(self) -> None:
        self._buf = np.zeros(0, dtype=np.float32)


class DelayLine:
    """DelayLine with optional fractional (linear-interp) delay
    (buffers.go:174-236)."""

    def __init__(self, max_delay_samples: int):
        self._buf = np.zeros(max_delay_samples + 1, dtype=np.float32)
        self._pos = 0

    def process(self, sample: float, delay_samples: int) -> float:
        self._buf[self._pos] = sample
        idx = (self._pos - delay_samples) % len(self._buf)
        out = float(self._buf[idx])
        self._pos = (self._pos + 1) % len(self._buf)
        return out

    def process_interpolated(self, sample: float, delay_samples: float) -> float:
        self._buf[self._pos] = sample
        d0 = int(np.floor(delay_samples))
        frac = delay_samples - d0
        i0 = (self._pos - d0) % len(self._buf)
        i1 = (self._pos - d0 - 1) % len(self._buf)
        out = float(self._buf[i0] * (1 - frac) + self._buf[i1] * frac)
        self._pos = (self._pos + 1) % len(self._buf)
        return out

    def clear(self) -> None:
        self._buf[:] = 0.0


class OverlapAddBuffer:
    """OverlapAddBuffer (buffers.go:239-296): reconstruct a stream from
    overlapping frames."""

    def __init__(self, window_size: int, hop_size: int):
        self.window_size = window_size
        self.hop_size = hop_size
        self._acc = np.zeros(window_size, dtype=np.float32)

    def add_frame(self, frame: np.ndarray) -> np.ndarray:
        frame = np.asarray(frame, dtype=np.float32)
        if len(frame) != self.window_size:
            raise ValueError("frame size mismatch")
        self._acc += frame
        out = self._acc[: self.hop_size].copy()
        self._acc = np.concatenate(
            [self._acc[self.hop_size:], np.zeros(self.hop_size, np.float32)]
        )
        return out

    def reset(self) -> None:
        self._acc[:] = 0.0
