"""Entropy analysis over histograms (counterpart of
`sonido_sonar_tpu/ops/stats/entropy.py`).

Reference parity: algorithms/stats/entropy.go:10-707 — Shannon, Renyi,
Tsallis, Hartley (log of support size), Min-entropy over value
histograms; bin-count selectors (Sturges, Rice, Scott,
Freedman-Diaconis, sqrt); entropy rate over symbol transitions;
conditional entropy.

The bin selectors and the entropy rate are host numpy, as in JAX; the
histogram is a count per row by `scatter_add_` on the input's device.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from sonido_sonar_tpu_torch.utils.device import DEFAULT_DEVICE, Device, as_float32

_EPS = 1e-12


# -- bin-count selectors (entropy.go:319-...) ---------------------------

def sturges_bins(n: int) -> int:
    return max(int(math.ceil(math.log2(max(n, 1)) + 1)), 1)


def rice_bins(n: int) -> int:
    return max(int(math.ceil(2.0 * n ** (1.0 / 3.0))), 1)


def sqrt_bins(n: int) -> int:
    return max(int(math.ceil(math.sqrt(n))), 1)


def scott_bins(x: np.ndarray) -> int:
    n = len(x)
    std = float(np.std(x))
    if std <= 0:
        return 1
    h = 3.49 * std / n ** (1.0 / 3.0)
    rng = float(np.max(x) - np.min(x))
    return max(int(math.ceil(rng / h)) if h > 0 else 1, 1)


def freedman_diaconis_bins(x: np.ndarray) -> int:
    n = len(x)
    q75, q25 = np.percentile(x, [75, 25])
    iqr = float(q75 - q25)
    if iqr <= 0:
        return sturges_bins(n)
    h = 2.0 * iqr / n ** (1.0 / 3.0)
    rng = float(np.max(x) - np.min(x))
    return max(int(math.ceil(rng / h)) if h > 0 else 1, 1)


def select_bins(x: np.ndarray, method: str = "sturges") -> int:
    n = len(x)
    if method == "sturges":
        return sturges_bins(n)
    if method == "rice":
        return rice_bins(n)
    if method == "sqrt":
        return sqrt_bins(n)
    if method == "scott":
        return scott_bins(x)
    if method in ("fd", "freedman-diaconis"):
        return freedman_diaconis_bins(x)
    raise ValueError(f"unknown bin selector {method}")


# -- histogram ------------------------------------------------------------

def histogram_probs(x: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Normalized histogram of the last axis, [..., N] -> [..., bins]:
    bin int32((x - lo) / width * bins), truncated toward zero and
    clipped to the last bin."""
    lo = torch.amin(x, dim=-1, keepdim=True)
    hi = torch.amax(x, dim=-1, keepdim=True)
    width = torch.clamp_min(hi - lo, _EPS)
    idx = torch.clamp(((x - lo) / width * num_bins).to(torch.int32), 0, num_bins - 1)
    counts = torch.zeros(x.shape[:-1] + (num_bins,), dtype=torch.float32, device=x.device)
    counts.scatter_add_(-1, idx.to(torch.int64), torch.ones_like(x, dtype=torch.float32))
    return counts / x.shape[-1]


# -- entropies (entropy.go:10-165, 515-707) -------------------------------

def shannon_entropy(p: torch.Tensor, base: float = 2.0) -> torch.Tensor:
    terms = torch.where(p > _EPS, -p * torch.log(torch.clamp_min(p, _EPS)), 0.0)
    return torch.sum(terms, dim=-1) / math.log(base)


def renyi_entropy(p: torch.Tensor, alpha: float = 2.0, base: float = 2.0) -> torch.Tensor:
    if abs(alpha - 1.0) < 1e-9:
        return shannon_entropy(p, base)
    s = torch.sum(torch.clamp_min(p, 0.0) ** alpha, dim=-1)
    return torch.log(torch.clamp_min(s, _EPS)) / (1.0 - alpha) / math.log(base)


def tsallis_entropy(p: torch.Tensor, q: float = 2.0) -> torch.Tensor:
    if abs(q - 1.0) < 1e-9:
        return shannon_entropy(p, math.e)
    s = torch.sum(torch.clamp_min(p, 0.0) ** q, dim=-1)
    return (1.0 - s) / (q - 1.0)


def hartley_entropy(p: torch.Tensor, base: float = 2.0) -> torch.Tensor:
    """log(#nonzero outcomes)."""
    support = torch.sum((p > _EPS).to(torch.float32), dim=-1)
    return torch.log(torch.clamp_min(support, 1.0)) / math.log(base)


def min_entropy(p: torch.Tensor, base: float = 2.0) -> torch.Tensor:
    return -torch.log(torch.clamp_min(torch.amax(p, dim=-1), _EPS)) / math.log(base)


def entropy_rate(symbols: np.ndarray, num_symbols: int) -> float:
    """Entropy rate from the first-order transition matrix
    (entropy.go entropy rate): H = -sum_i pi_i sum_j P_ij log2 P_ij."""
    s = np.asarray(symbols, dtype=np.int64)
    if len(s) < 2:
        return 0.0
    trans = np.zeros((num_symbols, num_symbols))
    for a, b in zip(s[:-1], s[1:]):
        trans[a, b] += 1
    row_sums = trans.sum(axis=1, keepdims=True)
    p_cond = np.divide(trans, row_sums, out=np.zeros_like(trans), where=row_sums > 0)
    pi = row_sums[:, 0] / max(row_sums.sum(), 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        logs = np.where(p_cond > 0, np.log2(p_cond), 0.0)
    return float(-np.sum(pi[:, None] * p_cond * logs))


def conditional_entropy(joint: torch.Tensor, base: float = 2.0) -> torch.Tensor:
    """H(Y|X) from a joint distribution [..., X, Y]."""
    joint = joint / torch.clamp_min(torch.sum(joint, dim=(-2, -1), keepdim=True), _EPS)
    px = torch.sum(joint, dim=-1, keepdim=True)
    p_cond = torch.where(px > _EPS, joint / torch.clamp_min(px, _EPS), 0.0)
    terms = torch.where(joint > _EPS, -joint * torch.log(torch.clamp_min(p_cond, _EPS)), 0.0)
    return torch.sum(terms, dim=(-2, -1)) / math.log(base)


def analyze(x, bin_method: str = "sturges", device: Device = DEFAULT_DEVICE) -> Dict[str, float]:
    """Entropy.Analyze (entropy.go:10-165): the full entropy profile of a
    value series. The bins are chosen on the float64 series; the
    histogram bins its float32 values (JAX runs with x64 off), on
    `device` (a tensor keeps its own)."""
    host = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
    host = np.asarray(host, dtype=np.float64)
    bins = select_bins(host, bin_method)
    src = x if isinstance(x, torch.Tensor) else host
    p = histogram_probs(as_float32(src, device)[None, :], bins)[0]
    shannon = float(shannon_entropy(p))
    return {
        "shannon": shannon,
        "renyi_2": float(renyi_entropy(p, 2.0)),
        "tsallis_2": float(tsallis_entropy(p, 2.0)),
        "hartley": float(hartley_entropy(p)),
        "min": float(min_entropy(p)),
        "num_bins": float(bins),
        "normalized": shannon / max(math.log2(bins), 1e-9),
    }
