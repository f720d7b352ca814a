"""Dynamic Time Warping: dense and Sakoe-Chiba-banded.

Counterpart of `sonido_sonar_tpu/ops/stats/dtw.py`, with the same
functions, arguments and results (reference parity: dtw.go — cost
matrix with +inf borders and cost[0][0] = 0, step patterns symmetric2 /
asymmetric / symmetric1, the band, the greedy backtrack preferring
vertical < horizontal < diagonal on strict less-than, distance
normalized by path length, quality metrics, step-pattern auto-select).

Each cost row is a min-plus scan D[j] = min(A[j], D[j-1] + c[j]); the
plain versions solve it with a log-step (Hillis-Steele) scan over the
row, rows in a Python loop. The banded fill and its backtrack,
`_fill_banded` and `_backtrack_banded`, are the plain versions of the
CUDA kernels in `csrc/dtw.cu` (wrappers `ops/stats/hopper_dtw.py` and
`ops/stats/hopper_backtrack.py`); the fill is the distance pre-pass
`_banded_local_distances` followed by the row recurrence
`_fill_banded_rows`, one kernel each. `dtw_align_banded` goes through the
wrappers, so a CUDA tensor runs the kernels. The dense path stays plain
PyTorch on every device, as it is XLA in JAX.

The greedy walks run on the host: a walk is a chain of data-dependent
scalar reads, which a Python loop does over a host copy of the costs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch

# finite "inf" of the fills: keeps min-plus sums finite (dtw.py:138, :344)
BIG = float(np.float32(3.4e38) / np.float32(4.0))


@dataclass
class DTWResult:
    """DTWResult (dtw.go:18-27) with a fixed-size path buffer.

    path_qidx/path_ridx are [N+M] int32; entries beyond path_length are
    padding (repeats of the first point). The path runs start -> end.
    """

    distance: torch.Tensor         # normalized (cost / path length)
    raw_distance: torch.Tensor     # cost[N][M]
    path_qidx: torch.Tensor        # [N+M]
    path_ridx: torch.Tensor        # [N+M]
    path_cost: torch.Tensor        # [N+M] local cost along the path
    path_length: torch.Tensor      # scalar int32
    cost_matrix: torch.Tensor      # [N+1, M+1], or the band [N+1, 2R+1]
    query_length: int
    ref_length: int
    step_pattern: str
    constraint: int


def _as_2d(x: torch.Tensor) -> torch.Tensor:
    return x[:, None] if x.dim() == 1 else x


def pairwise_sq_euclidean(query: torch.Tensor, reference: torch.Tensor) -> torch.Tensor:
    """[N, D] x [M, D] -> [N, M] squared distances via |q|^2 + |r|^2 - 2 q.r."""
    qn = torch.sum(query * query, dim=-1, keepdim=True)
    rn = torch.sum(reference * reference, dim=-1, keepdim=True)
    cross = query @ reference.T
    return torch.clamp_min(qn + rn.T - 2.0 * cross, 0.0)


def local_distance_matrix(
    query: torch.Tensor, reference: torch.Tensor, metric: str = "euclidean"
) -> torch.Tensor:
    """Local-cost matrix [N, M] for the dense fill (euclidean is the DTW
    default, dtw.go:42)."""
    query, reference = _as_2d(query), _as_2d(reference)
    if metric == "euclidean":
        return torch.sqrt(pairwise_sq_euclidean(query, reference))
    if metric == "sqeuclidean":
        return pairwise_sq_euclidean(query, reference)
    if metric == "manhattan":
        return torch.sum(torch.abs(query[:, None, :] - reference[None, :, :]), dim=-1)
    if metric == "cosine":
        qn = torch.linalg.norm(query, dim=-1, keepdim=True)
        rn = torch.linalg.norm(reference, dim=-1, keepdim=True)
        sim = (query @ reference.T) / torch.clamp_min(qn * rn.T, 1e-10)
        return 1.0 - sim
    raise ValueError(f"unknown metric {metric}")


def _minplus_row_scan(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Solve D[j] = min(A[j], D[j-1] + c[j]) along the last axis with
    D[-1] = +inf: an inclusive scan of (c, a) under
    (c1, a1) . (c2, a2) = (c1 + c2, min(a1 + c2, a2)), in log2(M) steps."""
    w = a.shape[-1]
    s = 1
    while s < w:
        c_new = c.clone()
        a_new = a.clone()
        c_new[..., s:] = c[..., :-s] + c[..., s:]
        a_new[..., s:] = torch.minimum(a[..., :-s] + c[..., s:], a[..., s:])
        c, a = c_new, a_new
        s <<= 1
    return a


def _fill_cost_matrix(local: torch.Tensor, step_pattern: str, band: int) -> torch.Tensor:
    """Padded cost matrix [(N+1), (M+1)] (dtw.go:105-135)."""
    n, m = local.shape
    dev = local.device
    if band > 0:
        ii = torch.arange(1, n + 1, device=dev)[:, None]
        jj = torch.arange(1, m + 1, device=dev)[None, :]
        local = torch.where(torch.abs(ii - jj) <= band, local, BIG)
    if step_pattern not in ("symmetric2", "asymmetric", "symmetric1"):
        raise ValueError(f"unknown step pattern {step_pattern}")
    extra = 1.0 if step_pattern == "symmetric1" else 0.0
    big1 = torch.full((1,), BIG, device=dev)
    cost = torch.empty((n + 1, m + 1), dtype=torch.float32, device=dev)
    cost[0] = BIG
    cost[0, 0] = 0.0
    prev = cost[0]
    for i in range(n):
        l_row = local[i]
        up, diag = prev[1:], prev[:-1]
        if step_pattern == "asymmetric":
            # the textbook Sakoe-Chiba asymmetric pattern (the JAX
            # package's documented deviation, dtw.py:158-168)
            diag2 = torch.cat([big1, prev[:-2]])
            v = torch.minimum(torch.minimum(up, diag), diag2)
            d = torch.clamp_max(l_row + v, BIG)
        else:
            if step_pattern == "symmetric2":
                v = torch.clamp_max(torch.minimum(up, diag), BIG)
            else:  # symmetric1: min(up + 1, diag), the chain carries +1
                v = torch.minimum(up + 1.0, diag)
            a = torch.clamp_max(l_row + v, BIG)
            c = torch.clamp_max(l_row + extra, BIG)
            d = torch.clamp_max(_minplus_row_scan(a, c), BIG)
        cost[i + 1, 0] = BIG
        cost[i + 1, 1:] = d
        prev = cost[i + 1]
    return cost


def _walk(get: Callable[[int, int], float], n: int, m: int) -> Tuple[list, list]:
    """Greedy walk from (n, m) to (0, 0) (dtw.go:165-217): the cells
    visited, in walk order. `get(i, j)` returns a float32 cost as a
    Python float, +inf where there is none."""
    i, j = n, m
    ii, jj = [], []
    while i > 0 or j > 0:
        ii.append(i)
        jj.append(j)
        if i == 0:
            j -= 1
            continue
        if j == 0:
            i -= 1
            continue
        up, left, diag = get(i - 1, j), get(i, j - 1), get(i - 1, j - 1)
        if diag < up and diag < left:
            i, j = i - 1, j - 1
        elif left < up:
            j -= 1
        else:
            i -= 1
    return ii, jj


def _path_outputs(ii: list, jj: list, cost_at, n: int, m: int, device):
    """(qs, rs, cs, length) in start -> end order from a walk, padded to
    n + m as dtw._backtrack pads (dtw.py:239-246). `cost_at(i, j)` gathers
    float32 costs for index tensors; cs = c(i, j) - c(i-1, j-1) in
    float32, 0 on the borders and where |cs| >= 1e30."""
    max_len = n + m
    length = len(ii)
    i_t = torch.tensor(ii[::-1], dtype=torch.int64)
    j_t = torch.tensor(jj[::-1], dtype=torch.int64)
    inner = (i_t > 0) & (j_t > 0)
    ih, jh = torch.where(inner, i_t, 1), torch.where(inner, j_t, 1)
    local = cost_at(ih, jh) - cost_at(ih - 1, jh - 1)
    local = torch.where(inner, local, 0.0)
    local = torch.where(torch.abs(local) < 1e30, local, 0.0)
    qs = torch.full((max_len,), ii[-1] - 1 if ii else 0, dtype=torch.int32)
    rs = torch.full((max_len,), jj[-1] - 1 if jj else 0, dtype=torch.int32)
    cs = torch.zeros((max_len,), dtype=torch.float32)
    qs[:length] = (i_t - 1).to(torch.int32)
    rs[:length] = (j_t - 1).to(torch.int32)
    cs[:length] = local
    return (qs.to(device), rs.to(device), cs.to(device),
            torch.tensor(length, dtype=torch.int32, device=device))


def _backtrack(cost: torch.Tensor, n: int, m: int):
    """Greedy backtrack over the dense cost matrix (dtw.go:165-217),
    ties toward vertical; -> (qs, rs, cs, length), qs/rs/cs [n + m]."""
    host = cost.detach().to("cpu", torch.float32)
    arr = host.numpy()
    ii, jj = _walk(lambda i, j: float(arr[i, j]), n, m)
    return _path_outputs(ii, jj, lambda i, j: host[i, j], n, m, cost.device)


def dtw_align(
    query: torch.Tensor,
    reference: torch.Tensor,
    step_pattern: str = "symmetric2",
    constraint_band: int = -1,
    metric: str = "euclidean",
) -> DTWResult:
    """DTWAlignment.Align (dtw.go:56-103) for [N, D] x [M, D] sequences."""
    query = _as_2d(query).to(torch.float32)
    reference = _as_2d(reference).to(torch.float32)
    n, m = int(query.shape[0]), int(reference.shape[0])
    local = local_distance_matrix(query, reference, metric)
    cost = _fill_cost_matrix(local, step_pattern, constraint_band)
    qs, rs, cs, length = _backtrack(cost, n, m)
    raw = cost[n, m]
    distance = raw / torch.clamp_min(length, 1).to(torch.float32)
    return DTWResult(distance, raw, qs, rs, cs, length, cost, n, m, step_pattern,
                     constraint_band)


def dtw_align_vectors(
    query: torch.Tensor, reference: torch.Tensor, step_pattern: str = "symmetric2",
    constraint_band: int = -1,
) -> DTWResult:
    """1-D helper (dtw.go:220-236)."""
    return dtw_align(query[:, None], reference[:, None], step_pattern, constraint_band)


def alignment_quality(result: DTWResult) -> dict:
    """GetAlignmentQuality (dtw.go:246-283)."""
    length = result.path_length
    lf = torch.clamp_min(length, 1).to(torch.float32)
    expected = float(max(result.query_length, result.ref_length))
    idx = torch.arange(result.path_qidx.shape[0] - 1, device=length.device)
    valid_step = idx + 1 < length
    q_inc = result.path_qidx[1:] > result.path_qidx[:-1]
    r_inc = result.path_ridx[1:] > result.path_ridx[:-1]
    diag = torch.sum((q_inc & r_inc & valid_step).to(torch.float32))
    valid_pts = torch.arange(result.path_cost.shape[0], device=length.device) < length
    total_cost = torch.sum(torch.where(valid_pts, result.path_cost, 0.0))
    return {
        "path_efficiency": expected / lf,
        "diagonal_ratio": diag / torch.clamp_min(lf - 1.0, 1.0),
        "average_cost": total_cost / lf,
        "normalized_distance": result.distance,
    }


def optimize_step_pattern(query: torch.Tensor, reference: torch.Tensor) -> str:
    """OptimizeStepPattern (dtw.go:286-311): the pattern with the lowest
    normalized distance."""
    best, best_d = "symmetric2", float("inf")
    for pattern in ("symmetric2", "asymmetric", "symmetric1"):
        d = float(dtw_align(query, reference, step_pattern=pattern).distance)
        if d < best_d:
            best, best_d = pattern, d
    return best


# ---------------------------------------------------------------------
# Banded DTW with O(T * band) memory: the plain versions of the kernels
# ---------------------------------------------------------------------

def _banded_local_distances(query: torch.Tensor, reference: torch.Tensor, band: int, n: int,
                            m: int) -> torch.Tensor:
    """Plain version of the fill's distance pre-pass (JAX's
    `pallas_dtw._banded_local_distances`, pallas_dtw.py:86, with the
    fill's first row on top).

    [n, d] x [m, d] -> [n+1, w], or [B, n, d] x [B, m, d] -> [B, n+1, w],
    w = 2 band + 1: row 0 is the fill's first row (0 at k == band, BIG
    elsewhere); row i >= 1 holds l[k] = ||q_{i-1} - r_{j-1}||, j = i -
    band + k, by the |q|^2 + |r|^2 - 2 q.r expansion from a window of the
    padded reference, BIG for j outside [1, m]. The dense [n, m] matrix
    never exists.
    """
    single = query.dim() == 2
    q = (query[None] if single else query).to(torch.float32)
    r = (reference[None] if single else reference).to(torch.float32)
    b = q.shape[0]
    w = 2 * band + 1
    pad_lo = band + 1
    pad_hi = band + 1 + max(0, n - m)
    ref_pad = torch.nn.functional.pad(r, (0, 0, pad_lo, pad_hi))
    ref_sq = torch.sum(ref_pad * ref_pad, dim=-1)
    k_idx = torch.arange(w, device=q.device)
    out = torch.empty((b, n + 1, w), dtype=torch.float32, device=q.device)
    out[:, 0] = torch.where(k_idx == band, 0.0, BIG)
    for i in range(1, n + 1):
        j_cols = i - band + k_idx
        q_i = q[:, i - 1]
        q_sq = torch.sum(q_i * q_i, dim=-1, keepdim=True)
        start = i - band - 1 + pad_lo
        cross = torch.sum(ref_pad[:, start: start + w] * q_i[:, None, :], dim=-1)
        l = torch.sqrt(torch.clamp_min(q_sq + ref_sq[:, start: start + w] - 2.0 * cross, 0.0))
        out[:, i] = torch.where((j_cols >= 1) & (j_cols <= m), l, BIG)
    return out[0] if single else out


def _fill_banded_rows(local: torch.Tensor, band: int, n: int, m: int) -> torch.Tensor:
    """Plain version of the fill's row recurrence (dtw.py:343-390 after
    the distances): over a band of local distances [.., n+1, w] as
    `_banded_local_distances` gives it, overwrite rows 1..n in place with
    D and return the band."""
    single = local.dim() == 2
    out = local[None] if single else local
    b, w = out.shape[0], 2 * band + 1
    k_idx = torch.arange(w, device=out.device)
    big1 = torch.full((b, 1), BIG, device=out.device)
    for i in range(1, n + 1):
        j_cols = i - band + k_idx
        l = out[:, i]
        prev = out[:, i - 1]
        up = torch.cat([prev[:, 1:], big1], dim=1)
        a = torch.clamp_max(l + torch.minimum(up, prev), BIG)
        c = torch.clamp_max(l, BIG)
        dk = torch.clamp_max(_minplus_row_scan(a, c), BIG)
        out[:, i] = torch.where((j_cols >= 1) & (j_cols <= m), dk, BIG)
    return local


def _fill_banded(query: torch.Tensor, reference: torch.Tensor, band: int, n: int, m: int
                 ) -> torch.Tensor:
    """Plain version of the banded fill (dtw.py:332-390), composed as the
    kernels compose it: the distance pre-pass, then the row recurrence in
    place.

    [n, d] x [m, d] -> [n+1, w], or [B, n, d] x [B, m, d] -> [B, n+1, w],
    w = 2 band + 1, cost_band[.., i, k] = cost[i, i - band + k] (BIG out
    of range).
    """
    return _fill_banded_rows(_banded_local_distances(query, reference, band, n, m), band, n, m)


def _backtrack_banded(cost_band: torch.Tensor, band: int, n: int, m: int):
    """Plain version of the backtrack kernel (dtw.py:394-446): the walk on
    the banded storage, a cell outside the band or the matrix reading
    +inf. [n+1, w] -> (qs, rs, cs [n+m], length), or [B, n+1, w] ->
    (qs, rs, cs [B, n+m], length [B])."""
    single = cost_band.dim() == 2
    bands = (cost_band[None] if single else cost_band).detach().to("cpu", torch.float32)
    w = 2 * band + 1
    outs = []
    for host in bands:
        arr = host.numpy()

        def get(i, j, arr=arr):
            k = j - i + band
            if i < 0 or j < 0 or k < 0 or k >= w:
                return float("inf")
            return float(arr[min(i, n), k])

        ii, jj = _walk(get, n, m)
        outs.append(_path_outputs(
            ii, jj, lambda i, j, host=host: host[i, j - i + band], n, m, cost_band.device))
    if single:
        return outs[0]
    return tuple(torch.stack([o[t] for o in outs]) for t in range(4))


def _banded_align_device(query: torch.Tensor, reference: torch.Tensor, band: int, n: int,
                         m: int):
    """Fill, backtrack and raw/normalized distance of one banded
    alignment, through the kernel wrappers."""
    from sonido_sonar_tpu_torch.ops.stats.hopper_backtrack import backtrack_banded_hopper
    from sonido_sonar_tpu_torch.ops.stats.hopper_dtw import fill_banded_hopper

    cost_band = fill_banded_hopper(query[None], reference[None], band, n, m)
    qs, rs, cs, length = backtrack_banded_hopper(cost_band, band, n, m)
    raw = cost_band[0, n, m - n + band]
    distance = raw / torch.clamp_min(length[0], 1).to(torch.float32)
    return cost_band[0], qs[0], rs[0], cs[0], length[0], raw, distance


def dtw_align_banded(query: torch.Tensor, reference: torch.Tensor, constraint_band: int
                     ) -> DTWResult:
    """Banded symmetric2 DTW with O(T * band) memory, semantically
    `dtw_align(..., constraint_band=R)` with the euclidean distance.
    Requires |N - M| <= band for a finite path."""
    query = _as_2d(query).to(torch.float32).contiguous()
    reference = _as_2d(reference).to(torch.float32).contiguous()
    n, m = int(query.shape[0]), int(reference.shape[0])
    if abs(n - m) > constraint_band:
        raise ValueError(f"|N-M| = {abs(n - m)} exceeds band {constraint_band}: no path")
    cost_band, qs, rs, cs, length, raw, distance = _banded_align_device(
        query, reference, constraint_band, n, m)
    return DTWResult(distance, raw, qs, rs, cs, length, cost_band, n, m, "symmetric2",
                     constraint_band)
