"""Corpus-scale fingerprint matching: one batched similarity matmul
(counterpart of `sonido_sonar_tpu/parallel/matcher.py`).

The reference's FindBestMatches loops Compare() over candidates
(comparison.go:197-263, 1107-1151). Here each fingerprint reduces to a
fixed-size statistics vector (the same statistics the pairwise
comparator uses); a corpus is a [C, D] matrix, a query is a [D] vector,
and matching is one segment-wise cosine pass + top-k. With a mesh the
corpus rows are split over its entries: each shard is scored and cut to
its top k on its device, and the shards' candidates are merged on the
host (all-gathered first under a process group), so the ranking is the
unsharded one, ties included.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sonido_sonar_tpu_torch.fingerprint.comparison import _to_host, _to_np, extract_mfcc_statistics
from sonido_sonar_tpu_torch.fingerprint.device_compare import (
    _device_of,
    _stable_topk,
    _tensor,
)
from sonido_sonar_tpu_torch.fingerprint.generator import AudioFingerprint
from sonido_sonar_tpu_torch.parallel.mesh import gather_processes, on_device, row_shards
from sonido_sonar_tpu_torch.utils.device import DEFAULT_DEVICE, Device, require_fp32_matmuls

_EPS = 1e-10


def pack_statistics(fp: AudioFingerprint, num_mfcc_coeffs: int = 13) -> np.ndarray:
    """Reduce a fingerprint to the comparator's statistics vector.

    Layout: [mfcc mean+std (2C) | chroma mean (12, zeros if absent) |
    centroid/rolloff/flux (mean, std) pairs (6)] — the exact quantities
    the pairwise comparator cosines over, concatenated. Segment-wise
    cosine happens in `sharded_top_k_matches`, not over the raw concat.

    num_mfcc_coeffs fixes the layout width; a fingerprint whose MFCC
    width disagrees is an error (a mixed corpus cannot share a packed
    matrix). Leaves may be tensors on any device.
    """
    f = fp.features
    parts = []
    if f.mfcc is not None:
        mfcc = _to_np(f.mfcc)
        if mfcc.shape[-1] != num_mfcc_coeffs:
            raise ValueError(
                f"fingerprint {fp.id} has {mfcc.shape[-1]} MFCC "
                f"coefficients, packed layout expects {num_mfcc_coeffs}"
            )
        parts.append(extract_mfcc_statistics(mfcc))
    else:
        parts.append(np.zeros(2 * num_mfcc_coeffs))
    if f.chroma_features is not None:
        parts.append(_to_np(f.chroma_features).mean(axis=0))
    else:
        parts.append(np.zeros(12))
    sf = f.spectral_features
    if sf is not None:
        for series in (sf.spectral_centroid, sf.spectral_rolloff, sf.spectral_flux):
            s = _to_np(series)
            parts.append(np.array([s.mean(), s.std(ddof=1) if len(s) > 1 else 0.0]))
    else:
        parts.append(np.zeros(6))
    return np.concatenate(parts).astype(np.float32)


def corpus_mfcc_width(fps: List[AudioFingerprint], default: int = 13) -> int:
    """MFCC coefficient count shared by a corpus (first one found)."""
    for fp in fps:
        if fp.features is not None and fp.features.mfcc is not None:
            return int(np.shape(fp.features.mfcc)[-1])
    return default


def fingerprint_matrix(
    fps: List[AudioFingerprint], num_mfcc_coeffs: Optional[int] = None
) -> np.ndarray:
    """[C, D] corpus matrix of packed statistics. The MFCC width is
    derived from the corpus unless given explicitly."""
    if num_mfcc_coeffs is None:
        num_mfcc_coeffs = corpus_mfcc_width(fps)
    return np.stack([pack_statistics(fp, num_mfcc_coeffs) for fp in fps])


def _segment_bounds(num_mfcc_coeffs: int = 13) -> Dict[str, Tuple[int, int]]:
    d_mfcc = 2 * num_mfcc_coeffs
    return {
        "mfcc": (0, d_mfcc),
        "chroma": (d_mfcc, d_mfcc + 12),
        "spectral": (d_mfcc + 12, d_mfcc + 18),
    }


def segment_cosine_similarities(
    query, corpus, weights, num_mfcc_coeffs: int = 13, device: Device = DEFAULT_DEVICE,
) -> torch.Tensor:
    """Weighted mean of per-segment cosine similarities, [C], on the
    corpus's device (a numpy corpus on `device`).

    Mirrors calculateFeatureSimilarity's weighted mean over the live
    stats-cosine terms (comparison.go:266-341) in one batched pass.
    weights: [3] (mfcc, chroma, spectral). The dot products run in true
    float32 (JAX's Precision.HIGHEST): TF32 on a card raises.
    """
    dev = _device_of(corpus, device)
    X = _tensor(corpus, dev, torch.float32)
    require_fp32_matmuls(X, "segment_cosine_similarities")
    q = _tensor(query, dev, torch.float32)
    w = _tensor(weights, dev, torch.float32)
    total = 0.0
    for i, (lo, hi) in enumerate(_segment_bounds(num_mfcc_coeffs).values()):
        qs, cs = q[lo:hi], X[:, lo:hi]
        qn = torch.linalg.vector_norm(qs)
        cn = torch.linalg.vector_norm(cs, dim=-1)
        dot = cs @ qs
        sim = torch.where((qn > _EPS) & (cn > _EPS), dot / torch.clamp_min(qn * cn, _EPS), 0.0)
        total = total + sim * w[i]
    return total / torch.clamp_min(w.sum(), _EPS)


def sharded_top_k_matches(
    query_vec,
    corpus,
    k: int = 10,
    mesh=None,
    weights: Tuple[float, float, float] = (0.40, 0.20, 0.25),
    num_mfcc_coeffs: int = 13,
    device: Device = DEFAULT_DEVICE,
) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k most similar corpus rows. Returns (indices [k] int32,
    scores [k]) as numpy, equal scores lowest index first.

    Without a mesh the corpus is scored on one device (the corpus's, or
    `device` for numpy). With a mesh its rows are split as JAX pads and
    shards them (`mesh.row_shards`), the query replicated: each shard is
    scored and cut to its own top k on its device, every shard launched
    before any result is read, then the candidates are merged by a stable
    sort on the host. Under a process group every rank scores its rows,
    the candidates are all-gathered, and every rank returns the same
    result. The corpus is the whole [C, D] on every rank.
    """
    w = np.asarray(weights, dtype=np.float32)
    c = corpus.shape[0]
    shards = [(_device_of(corpus, device), 0, c)] if mesh is None else row_shards(c, mesh)
    parts = []
    for dev, lo, hi in shards:
        with on_device(dev):
            sims = segment_cosine_similarities(
                query_vec, _tensor(corpus[lo:hi], dev), w, num_mfcc_coeffs, device=dev)
            scores, idx = _stable_topk(sims, min(k, hi - lo))
            parts.append((dev, {"index": idx.to(torch.int32) + lo, "score": scores}))
    host = []
    for dev, part in parts:
        with on_device(dev):
            host.append(_to_host(part))
    if mesh is not None:
        host = [h for rank in gather_processes(host, mesh) for h in rank]
    index = np.concatenate([h["index"] for h in host])
    score = np.concatenate([h["score"] for h in host])
    # the candidates come in row order, so a stable sort keeps ties
    # lowest index first, as the unsharded sort does
    best = np.argsort(-score, kind="stable")[:min(k, c)]
    return index[best], score[best]
