"""Distance functions, distance matrices, kNN (counterpart of
`sonido_sonar_tpu/ops/stats/distance.py`).

Reference parity: algorithms/stats/distance.go:8-436 — metrics Euclid,
Manhattan, Cosine, Pearson, Chebyshev, Minkowski, Hamming, Jaccard,
Canberra, Bray-Curtis, KL, JS, Hellinger, Bhattacharyya, 1-D EMD
(+ Mahalanobis, a stub in the reference, implemented properly here);
GetDistanceFunction registry, distance matrix, kNN.

Every metric reduces the last axis and broadcasts the others. The
distance matrix takes the Euclidean metrics through the matmul identity
(`dtw.pairwise_sq_euclidean`) and the others as an [n, M, D] broadcast
over chunks of query rows, each chunk's temporaries within
MATRIX_CHUNK_BYTES.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from sonido_sonar_tpu_torch.ops.stats.dtw import pairwise_sq_euclidean
from sonido_sonar_tpu_torch.utils.device import require_fp32_matmuls

_EPS = 1e-10
# bytes of one [n, M, D] float32 temporary of distance_matrix's broadcast
MATRIX_CHUNK_BYTES = 256 * 2**20


def euclidean(a, b):
    d = a - b
    return torch.sqrt(torch.sum(d * d, dim=-1))


def sq_euclidean(a, b):
    d = a - b
    return torch.sum(d * d, dim=-1)


def manhattan(a, b):
    return torch.sum(torch.abs(a - b), dim=-1)


def chebyshev(a, b):
    return torch.amax(torch.abs(a - b), dim=-1)


def minkowski(a, b, p: float = 3.0):
    return torch.sum(torch.abs(a - b) ** p, dim=-1) ** (1.0 / p)


def cosine(a, b):
    """1 - cosine similarity."""
    na = torch.linalg.vector_norm(a, dim=-1)
    nb = torch.linalg.vector_norm(b, dim=-1)
    dot = torch.sum(a * b, dim=-1)
    sim = torch.where((na > _EPS) & (nb > _EPS), dot / torch.clamp_min(na * nb, _EPS), 0.0)
    return 1.0 - sim


def pearson(a, b):
    """1 - Pearson correlation."""
    am = a - torch.mean(a, dim=-1, keepdim=True)
    bm = b - torch.mean(b, dim=-1, keepdim=True)
    num = torch.sum(am * bm, dim=-1)
    den = torch.sqrt(torch.sum(am * am, dim=-1) * torch.sum(bm * bm, dim=-1))
    corr = torch.where(den > _EPS, num / torch.clamp_min(den, _EPS), 0.0)
    return 1.0 - corr


def hamming(a, b):
    """Fraction of differing entries."""
    return torch.mean((a != b).to(torch.float32), dim=-1)


def jaccard(a, b):
    """1 - |min|/|max| (weighted Jaccard for non-negative vectors)."""
    num = torch.sum(torch.minimum(a, b), dim=-1)
    den = torch.sum(torch.maximum(a, b), dim=-1)
    return 1.0 - torch.where(den > _EPS, num / torch.clamp_min(den, _EPS), 0.0)


def canberra(a, b):
    den = torch.abs(a) + torch.abs(b)
    terms = torch.where(den > _EPS, torch.abs(a - b) / torch.clamp_min(den, _EPS), 0.0)
    return torch.sum(terms, dim=-1)


def bray_curtis(a, b):
    num = torch.sum(torch.abs(a - b), dim=-1)
    den = torch.sum(torch.abs(a + b), dim=-1)
    return torch.where(den > _EPS, num / torch.clamp_min(den, _EPS), 0.0)


def _normalize_dist(p):
    s = torch.sum(p, dim=-1, keepdim=True)
    return torch.where(s > _EPS, p / torch.clamp_min(s, _EPS), p)


def kl_divergence(p, q):
    """sum p log(p/q) over normalized distributions."""
    p = _normalize_dist(torch.clamp_min(p, 0.0))
    q = _normalize_dist(torch.clamp_min(q, 0.0))
    terms = torch.where(
        p > _EPS, p * torch.log(torch.clamp_min(p, _EPS) / torch.clamp_min(q, _EPS)), 0.0
    )
    return torch.sum(terms, dim=-1)


def js_divergence(p, q):
    p = _normalize_dist(torch.clamp_min(p, 0.0))
    q = _normalize_dist(torch.clamp_min(q, 0.0))
    m = 0.5 * (p + q)
    return 0.5 * kl_divergence(p, m) + 0.5 * kl_divergence(q, m)


def hellinger(p, q):
    p = _normalize_dist(torch.clamp_min(p, 0.0))
    q = _normalize_dist(torch.clamp_min(q, 0.0))
    return torch.sqrt(
        torch.clamp_min(0.5 * torch.sum((torch.sqrt(p) - torch.sqrt(q)) ** 2, dim=-1), 0.0)
    )


def bhattacharyya(p, q):
    p = _normalize_dist(torch.clamp_min(p, 0.0))
    q = _normalize_dist(torch.clamp_min(q, 0.0))
    bc = torch.sum(torch.sqrt(p * q), dim=-1)
    return -torch.log(torch.clamp_min(bc, _EPS))


def emd_1d(p, q):
    """1-D earth mover's distance = L1 of CDF difference."""
    p = _normalize_dist(torch.clamp_min(p, 0.0))
    q = _normalize_dist(torch.clamp_min(q, 0.0))
    return torch.sum(torch.abs(torch.cumsum(p - q, dim=-1)), dim=-1)


def mahalanobis(a, b, inv_cov):
    """sqrt((a-b)^T S^-1 (a-b)). The reference stubs this
    (distance.go Mahalanobis); implemented properly here."""
    d = a - b
    return torch.sqrt(torch.clamp_min(torch.einsum("...i,ij,...j->...", d, inv_cov, d), 0.0))


_REGISTRY: Dict[str, Callable] = {
    "euclidean": euclidean,
    "sqeuclidean": sq_euclidean,
    "manhattan": manhattan,
    "chebyshev": chebyshev,
    "minkowski": minkowski,
    "cosine": cosine,
    "pearson": pearson,
    "hamming": hamming,
    "jaccard": jaccard,
    "canberra": canberra,
    "braycurtis": bray_curtis,
    "kl": kl_divergence,
    "js": js_divergence,
    "hellinger": hellinger,
    "bhattacharyya": bhattacharyya,
    "emd": emd_1d,
}


def get_distance_function(metric: str) -> Callable:
    """GetDistanceFunction (distance.go:8-60)."""
    fn = _REGISTRY.get(metric)
    if fn is None:
        raise ValueError(f"unknown distance metric {metric}")
    return fn


def distance_matrix(x: torch.Tensor, y: torch.Tensor, metric: str = "euclidean") -> torch.Tensor:
    """[N, D] x [M, D] -> [N, M] (distance.go DistanceMatrix)."""
    if metric in ("euclidean", "sqeuclidean"):
        require_fp32_matmuls(x, "distance_matrix")
        d2 = pairwise_sq_euclidean(x, y)
        return torch.sqrt(d2) if metric == "euclidean" else d2
    fn = get_distance_function(metric)
    m, d = y.shape
    rows = max(1, MATRIX_CHUNK_BYTES // max(4 * m * d, 1))
    yb = y[None, :, :]
    return torch.cat([fn(x[i:i + rows, None, :], yb) for i in range(0, x.shape[0], rows)])


def knn(
    query: torch.Tensor, data: torch.Tensor, k: int, metric: str = "euclidean"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest rows of data [M, D] to query [D] -> (int32 indices,
    distances) (distance.go kNN), nearest first and tied distances in
    ascending index order, as `lax.top_k` returns them: a stable sort."""
    dist = distance_matrix(query[None, :], data, metric)[0]
    srt = torch.sort(dist, stable=True)
    kk = min(k, data.shape[0])
    return srt.indices[:kk].to(torch.int32), srt.values[:kk]
