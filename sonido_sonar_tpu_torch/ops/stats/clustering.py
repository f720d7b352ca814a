"""Clustering: KMeans with kmeans++ init, inertia, silhouette
(counterpart of `sonido_sonar_tpu/ops/stats/clustering.py`).

Reference parity: algorithms/stats/clustering.go:10-1228 — KMeans is the
implemented algorithm (kmeans++ init, Lloyd iterations, inertia,
silhouette score); KMedoids/Hierarchical/DBSCAN/GMM exist upstream only
as enums.

The kmeans++ seeding and the silhouette score are host numpy, as in JAX
(the same generator draws, so the same seeds). The Lloyd iterations run
on the input's device: `max_iter` fixed steps of one [N, K] distance
matmul, the first nearest centroid, and the cluster sums as a one-hot
[K, N] x [N, D] matmul; an empty cluster keeps its centroid.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sonido_sonar_tpu_torch.ops.stats.dtw import pairwise_sq_euclidean
from sonido_sonar_tpu_torch.utils.device import DEFAULT_DEVICE, Device, require_fp32_matmuls

_EPS = 1e-10


@dataclass
class ClusteringResult:
    """ClusteringResult (clustering.go)."""

    labels: np.ndarray       # [N]
    centroids: np.ndarray    # [K, D]
    inertia: float
    silhouette: float
    n_iter: int


def _kmeanspp_init(x: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """kmeans++ seeding (clustering.go kmeans++ init)."""
    n = x.shape[0]
    centroids = [x[rng.integers(n)]]
    for _ in range(1, k):
        d2 = np.min(
            [((x - c) ** 2).sum(axis=1) for c in centroids], axis=0
        )
        probs = d2 / max(d2.sum(), _EPS)
        centroids.append(x[rng.choice(n, p=probs)])
    return np.stack(centroids)


def _lloyd(x: torch.Tensor, init: torch.Tensor, max_iter: int):
    """(labels [N], centroids [K, D], inertia) after max_iter steps."""
    k = init.shape[0]
    cent = init
    for _ in range(max_iter):
        labels = torch.argmin(pairwise_sq_euclidean(x, cent), dim=-1)
        one_hot = torch.nn.functional.one_hot(labels, k).to(torch.float32)   # [N, K]
        counts = torch.sum(one_hot, dim=0)[:, None]
        sums = one_hot.T @ x
        cent = torch.where(counts > 0, sums / torch.clamp_min(counts, 1.0), cent)
    d2 = pairwise_sq_euclidean(x, cent)
    return torch.argmin(d2, dim=-1), cent, torch.sum(torch.amin(d2, dim=-1))


def silhouette_score(x: np.ndarray, labels: np.ndarray) -> float:
    """Mean silhouette over samples (clustering.go silhouette). Host
    numpy; above 2,000 points (or with one label) a seeded subsample of
    2,000, as in JAX."""
    n = x.shape[0]
    uniq = np.unique(labels)
    if len(uniq) < 2 or n > 2000:
        # silhouette is O(N^2); cap like the reference's practical use
        idx = np.random.default_rng(0).choice(n, size=min(n, 2000), replace=False)
        x, labels = x[idx], labels[idx]
        n = x.shape[0]
        uniq = np.unique(labels)
        if len(uniq) < 2:
            return 0.0
    d = np.sqrt(np.maximum(
        (x**2).sum(1)[:, None] + (x**2).sum(1)[None, :] - 2 * x @ x.T, 0
    ))
    scores = np.zeros(n)
    for i in range(n):
        same = labels == labels[i]
        same[i] = False
        a = d[i][same].mean() if same.any() else 0.0
        b = np.inf
        for c in uniq:
            if c == labels[i]:
                continue
            mask = labels == c
            if mask.any():
                b = min(b, d[i][mask].mean())
        denom = max(a, b)
        scores[i] = (b - a) / denom if denom > 0 else 0.0
    return float(scores.mean())


class Clustering:
    """Clustering.Fit (clustering.go:10-156). Only kmeans is implemented
    (as upstream); other algorithm names raise. A tensor input keeps its
    device; numpy input goes to `device`."""

    def __init__(self, algorithm: str = "kmeans", num_clusters: int = 8,
                 max_iter: int = 50, seed: int = 0, device: Device = DEFAULT_DEVICE):
        if algorithm not in ("kmeans",):
            raise NotImplementedError(
                f"{algorithm}: the reference implements only kmeans "
                "(others are enum stubs, clustering.go:133-156)"
            )
        self.k = num_clusters
        self.max_iter = max_iter
        self.seed = seed
        self.device = device

    def fit(self, x) -> ClusteringResult:
        if isinstance(x, torch.Tensor):
            xt = x.to(torch.float32)
            x = xt.cpu().numpy()
        else:
            x = np.asarray(x, dtype=np.float32)
            xt = torch.from_numpy(x).to(self.device)
        require_fp32_matmuls(xt, "Clustering.fit")
        rng = np.random.default_rng(self.seed)
        init = _kmeanspp_init(x, self.k, rng)
        labels, cent, inertia = _lloyd(xt, torch.from_numpy(init).to(xt.device), self.max_iter)
        labels = labels.to(torch.int32).cpu().numpy()
        return ClusteringResult(
            labels=labels,
            centroids=cent.cpu().numpy(),
            inertia=float(inertia),
            silhouette=silhouette_score(x, labels),
            n_iter=self.max_iter,
        )
