"""Statistical moments (counterpart of `sonido_sonar_tpu/ops/stats/moments.py`).

Reference parity: algorithms/stats/moments.go:10-625 — mean/variance
(classic + Welford streaming), skewness (moment-based + Pearson's
mode/median variants + Bowley quartile skewness), kurtosis (excess),
raw/central/standardized/absolute moments, L-moments (l1..l4 + ratios),
cumulants (k1..k4).

The quantiles and medians are `sorted_quantiles`: one sort of the last
axis, then JAX's float32 index q * (n - 1) and its interpolation.
`torch.quantile` is not used: it refuses inputs above 2^24 elements, and
`torch.median` returns the lower of the two middle values where
`jnp.median` averages them.
"""

from __future__ import annotations

from math import comb as mcomb
from typing import Dict, List, Sequence

import numpy as np
import torch

from sonido_sonar_tpu_torch.utils.device import DEFAULT_DEVICE, Device, as_float32

_EPS = 1e-12


def sorted_quantiles(
    x: torch.Tensor, qs: Sequence[float], method: str = "linear", keepdim: bool = False
) -> List[torch.Tensor]:
    """`jnp.quantile(x, q, axis=-1)` for each q, from one sort of the last
    axis. The position q * (n - 1) is a float32 product; "linear" gives
    low * (1 - w) + high * w, "midpoint" (`jnp.median`) (low + high) / 2.
    A row holding a NaN gives NaN, as in JAX."""
    if method not in ("linear", "midpoint"):
        raise ValueError(f"unsupported quantile method {method}")
    n = x.shape[-1]
    srt = torch.sort(x, dim=-1).values
    has_nan = torch.isnan(x).any(dim=-1, keepdim=True)
    out = []
    for q in qs:
        pos = np.float32(q) * np.float32(n - 1)
        low, high = np.floor(pos), np.ceil(pos)
        hw = np.float32(pos - low)
        lw = np.float32(1.0) - hw
        lo = int(min(max(low, 0), n - 1))
        hi = int(min(max(high, 0), n - 1))
        a, b = srt[..., lo:lo + 1], srt[..., hi:hi + 1]
        v = a * float(lw) + b * float(hw) if method == "linear" else (a + b) * 0.5
        v = torch.where(has_nan, float("nan"), v)
        out.append(v if keepdim else v[..., 0])
    return out


def median(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """`jnp.median` over the last axis: the mean of the two middle values
    on an even count."""
    return sorted_quantiles(x, (0.5,), "midpoint", keepdim)[0]


def mean(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x, dim=-1)


def variance(x: torch.Tensor, sample: bool = True) -> torch.Tensor:
    """Sample (N-1) by default, matching gonum/the reference."""
    n = x.shape[-1]
    m = torch.mean(x, dim=-1, keepdim=True)
    ss = torch.sum((x - m) ** 2, dim=-1)
    return ss / max(n - 1, 1) if sample else ss / n


def raw_moment(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.mean(x**k, dim=-1)


def central_moment(x: torch.Tensor, k: int) -> torch.Tensor:
    m = torch.mean(x, dim=-1, keepdim=True)
    return torch.mean((x - m) ** k, dim=-1)


def standardized_moment(x: torch.Tensor, k: int) -> torch.Tensor:
    m2 = central_moment(x, 2)
    mk = central_moment(x, k)
    return torch.where(m2 > _EPS, mk / torch.clamp_min(m2, _EPS) ** (k / 2.0), 0.0)


def absolute_moment(x: torch.Tensor, k: int) -> torch.Tensor:
    m = torch.mean(x, dim=-1, keepdim=True)
    return torch.mean(torch.abs(x - m) ** k, dim=-1)


def skewness(x: torch.Tensor) -> torch.Tensor:
    """Moment-based (g1) skewness."""
    return standardized_moment(x, 3)


def pearson_skewness(x: torch.Tensor) -> torch.Tensor:
    """Pearson's second coefficient: 3(mean - median)/std."""
    m = torch.mean(x, dim=-1)
    med = median(x)
    s = torch.sqrt(variance(x, sample=False))
    return torch.where(s > _EPS, 3.0 * (m - med) / torch.clamp_min(s, _EPS), 0.0)


def bowley_skewness(x: torch.Tensor) -> torch.Tensor:
    """Quartile skewness (Q3 + Q1 - 2 Q2)/(Q3 - Q1)."""
    q1, q2, q3 = sorted_quantiles(x, (0.25, 0.50, 0.75))
    iqr = q3 - q1
    return torch.where(iqr > _EPS, (q3 + q1 - 2 * q2) / torch.clamp_min(iqr, _EPS), 0.0)


def kurtosis(x: torch.Tensor, excess: bool = True) -> torch.Tensor:
    k = standardized_moment(x, 4)
    return k - 3.0 if excess else k


def welford(x: np.ndarray) -> Dict[str, float]:
    """Streaming mean/variance (Welford, moments.go Welford variant).
    Host-side: validates numerical agreement with the batched path."""
    mean_ = 0.0
    m2 = 0.0
    n = 0
    for v in np.asarray(x, dtype=np.float64):
        n += 1
        delta = v - mean_
        mean_ += delta / n
        m2 += delta * (v - mean_)
    var = m2 / (n - 1) if n > 1 else 0.0
    return {"mean": mean_, "variance": var, "count": n}


def l_moments(x: np.ndarray) -> Dict[str, float]:
    """First four L-moments + ratios (moments.go L-moments), via the
    direct order-statistics formula, host float64."""
    xs = np.sort(np.asarray(x, dtype=np.float64))
    n = len(xs)
    if n < 4:
        return {"l1": float(np.mean(xs)) if n else 0.0, "l2": 0.0, "l3": 0.0,
                "l4": 0.0, "t3": 0.0, "t4": 0.0}
    i = np.arange(n)

    def comb(a, b):
        return np.array([mcomb(int(v), b) for v in a], dtype=np.float64)

    c1 = comb(i, 1)
    c2 = comb(i, 2)
    c3 = comb(i, 3)
    b0 = xs.mean()
    b1 = np.sum(c1 * xs) / (n * mcomb(n - 1, 1))
    b2 = np.sum(c2 * xs) / (n * mcomb(n - 1, 2))
    b3 = np.sum(c3 * xs) / (n * mcomb(n - 1, 3))
    l1 = b0
    l2 = 2 * b1 - b0
    l3 = 6 * b2 - 6 * b1 + b0
    l4 = 20 * b3 - 30 * b2 + 12 * b1 - b0
    t3 = l3 / l2 if abs(l2) > _EPS else 0.0
    t4 = l4 / l2 if abs(l2) > _EPS else 0.0
    return {"l1": float(l1), "l2": float(l2), "l3": float(l3), "l4": float(l4),
            "t3": float(t3), "t4": float(t4)}


def cumulants(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """First four cumulants (moments.go cumulants): k1 = mean,
    k2 = m2, k3 = m3, k4 = m4 - 3 m2^2 (central-moment identities)."""
    m = torch.mean(x, dim=-1)
    m2 = central_moment(x, 2)
    m3 = central_moment(x, 3)
    m4 = central_moment(x, 4)
    return {"k1": m, "k2": m2, "k3": m3, "k4": m4 - 3.0 * m2 * m2}


def analyze(x, device: Device = DEFAULT_DEVICE) -> Dict[str, float]:
    """Moments.Analyze (moments.go:10-150): full moment profile of a 1-D
    series, the batched moments in float32 on `device` (a tensor keeps
    its own), the L-moments on the host in float64."""
    xj = as_float32(x, device)
    out = {
        "mean": float(mean(xj)),
        "variance": float(variance(xj)),
        "std": float(torch.sqrt(variance(xj))),
        "skewness": float(skewness(xj)),
        "pearson_skewness": float(pearson_skewness(xj)),
        "bowley_skewness": float(bowley_skewness(xj)),
        "kurtosis": float(kurtosis(xj)),
    }
    out.update({k: float(v) for k, v in cumulants(xj).items()})
    host = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    out.update(l_moments(host))
    return out
