"""Chroma vector/sequence analysis: stats, distances, OTI, sequence
similarity (6 methods), pitch-class relationships, Tonnetz (counterpart
of `sonido_sonar_tpu/ops/chroma_analysis.py`).

Reference parity: algorithms/chroma/ —
  chroma_vector.go: 12-d stats (energy/centroid/entropy/sparsity/
    uniformity), distances (cosine, euclidean, correlation, KL, JS,
    Hellinger), optimal circular shift (OTI), interpolation, smoothing,
    dominant chroma, templates (:12-330);
  chroma_similarity.go: Direct (cross-similarity mean, optional
    transposition invariance), Binary (threshold 0.4), Smith-Waterman
    (gap penalty 0.1), DTW (slanted band, exp(-d) similarity), QMax
    (diagonal maxima), OTI (:8-450);
  pitch_class.go: circle of fifths, key relationships, transposition
    search (:27-441);
  tonnetz.go: lattice coordinates (fifths x-axis, major-third y in
    sqrt(3)/2 steps, :60-107), trajectory/movement, harmonic tension,
    consonance, voice leading (:31-565), and the 6-d tonal centroid.

The sequence similarities run row by row on the input's device, as
JAX's `lax.scan` does: Smith-Waterman's row recurrence
S[j] = max(a[j], S[j-1] - gap) in the closed form
cummax(a + j gap) - j gap, and DTW's rows through the min-plus scan of
`stats/dtw.py`. Their results, like JAX's, are host numpy.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sonido_sonar_tpu_torch.ops.stats.moments import median
from sonido_sonar_tpu_torch.ops.tables import device_table
from sonido_sonar_tpu_torch.utils.device import (
    DEFAULT_DEVICE, Device, as_float32, require_fp32_matmuls,
)

_EPS = 1e-10


# ---------------------------------------------------------------------
# Chroma vector analysis (chroma_vector.go)
# ---------------------------------------------------------------------

def chroma_stats(cv: torch.Tensor) -> Dict[str, torch.Tensor]:
    """ComputeStats (chroma_vector.go:96-144): energy, centroid (circular
    pitch-class mean), entropy, sparsity, uniformity. cv: [..., 12]."""
    energy = torch.sqrt(torch.sum(cv * cv, dim=-1))
    total = torch.sum(cv, dim=-1, keepdim=True)
    p = torch.where(total > _EPS, cv / torch.clamp_min(total, _EPS), 0.0)
    # circular centroid over pitch-class angles
    angles = 2.0 * math.pi * torch.arange(12, dtype=torch.float32, device=cv.device) / 12.0
    cx = torch.sum(p * torch.cos(angles), dim=-1)
    cy = torch.sum(p * torch.sin(angles), dim=-1)
    centroid = torch.remainder(torch.atan2(cy, cx) / (2.0 * math.pi) * 12.0, 12.0)
    entropy = torch.sum(
        torch.where(p > _EPS, -p * torch.log2(torch.clamp_min(p, _EPS)), 0.0), dim=-1
    )
    l1 = torch.sum(torch.abs(cv), dim=-1)
    l2 = torch.sqrt(torch.sum(cv * cv, dim=-1))
    sqrt12 = float(np.float32(math.sqrt(12.0)))
    sparsity = torch.where(
        l1 > _EPS,
        (sqrt12 - l1 / torch.clamp_min(l2, _EPS)) / (sqrt12 - 1.0),
        0.0,
    )
    uniformity = (1.0 - torch.std(p, dim=-1, correction=0)
                  / torch.clamp_min(torch.mean(p, dim=-1), _EPS) / float(np.float32(math.sqrt(11.0))))
    return {
        "energy": energy,
        "centroid": centroid,
        "entropy": entropy,
        "sparsity": torch.clamp(sparsity, 0.0, 1.0),
        "uniformity": torch.clamp(uniformity, 0.0, 1.0),
    }


def chroma_distance(a: torch.Tensor, b: torch.Tensor, metric: str = "cosine") -> torch.Tensor:
    """Distance (chroma_vector.go:146-170)."""
    from sonido_sonar_tpu_torch.ops.stats import distance as D

    fns = {
        "cosine": D.cosine,
        "euclidean": D.euclidean,
        "correlation": D.pearson,
        "kl": D.kl_divergence,
        "js": D.js_divergence,
        "hellinger": D.hellinger,
    }
    if metric not in fns:
        raise ValueError(f"unknown chroma distance {metric}")
    return fns[metric](a, b)


def chroma_similarity(a: torch.Tensor, b: torch.Tensor, metric: str = "cosine") -> torch.Tensor:
    """Similarity = 1 - distance, clamped (chroma_vector.go:172-187)."""
    return torch.clamp(1.0 - chroma_distance(a, b, metric), 0.0, 1.0)


def circular_shift(cv: torch.Tensor, shift: int) -> torch.Tensor:
    """CircularShift (chroma_vector.go:207-217)."""
    return torch.roll(cv, shift, dims=-1)


def optimal_transposition(
    a: torch.Tensor, b: torch.Tensor, metric: str = "cosine"
) -> Tuple[int, float]:
    """ShiftOptimal / OTI (chroma_vector.go:189-205): the shift of `a`
    (a [12] vector) maximizing its similarity to `b`. The twelve
    similarities are one batched call read to the host once; the first
    of equal values wins, as JAX's loop takes them."""
    shifted = torch.stack([torch.roll(a, s, dims=-1) for s in range(12)])
    sims = chroma_similarity(shifted, b, metric).tolist()
    best_shift, best_sim = 0, -1.0
    for s, sim in enumerate(sims):
        if sim > best_sim:
            best_shift, best_sim = s, sim
    return best_shift, best_sim


def interpolate_chroma(a: torch.Tensor, b: torch.Tensor, t: float) -> torch.Tensor:
    """Interpolate (chroma_vector.go:219-243)."""
    return (1.0 - t) * a + t * b


def smooth_chroma(seq: torch.Tensor, window: int = 3) -> torch.Tensor:
    """Moving-average smoothing over the time axis with edge padding
    (chroma_vector.go:245-278). seq: [T, 12]."""
    t = seq.shape[0]
    pad = window // 2
    idx = (torch.arange(t, device=seq.device)[:, None]
           + torch.arange(window, device=seq.device)[None, :] - pad)
    return torch.mean(seq[torch.clamp(idx, 0, t - 1)], dim=1)


def dominant_chroma(cv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """FindDominantChroma (chroma_vector.go:280-293)."""
    return torch.argmax(cv, dim=-1).to(torch.int32), torch.amax(cv, dim=-1)


def chroma_template(seq: torch.Tensor) -> torch.Tensor:
    """ComputeChromaTemplate: normalized mean (chroma_vector.go:295-318)."""
    mean = torch.mean(seq, dim=-2)
    total = torch.sum(mean, dim=-1, keepdim=True)
    return torch.where(total > _EPS, mean / torch.clamp_min(total, _EPS), mean)


# ---------------------------------------------------------------------
# Chroma sequence similarity (chroma_similarity.go)
# ---------------------------------------------------------------------

@dataclass
class ChromaSimilarityResult:
    """ChromaSimilarityResult (chroma_similarity.go:30-55)."""

    similarity_matrix: np.ndarray
    overall_similarity: float
    method: str
    best_transposition: int = 0
    query_frames: int = 0
    reference_frames: int = 0


def _cross_similarity_matrix(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Cosine cross-similarity [Tq, Tr]: one float32 matmul (TF32 off)."""
    require_fp32_matmuls(q, "chroma cross-similarity")
    qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    rn = torch.linalg.vector_norm(r, dim=-1, keepdim=True)
    sim = torch.matmul(q, r.T) / torch.clamp_min(qn * rn.T, _EPS)
    return torch.clamp(sim, -1.0, 1.0)


def dtw_band_mask(tq: int, tr: int, radius: int, device=None) -> torch.Tensor:
    """The slanted band |i - int32(j * tq / tr)| <= radius as JAX
    computes it: the integer product j * tq converted to float32 (it
    rounds above 2^24) and divided in float32, truncated."""
    ii = torch.arange(tq, device=device)[:, None]
    jj = torch.arange(tr, device=device)[None, :]
    expected = ((jj * tq).to(torch.float32) / float(tr)).to(torch.int32)
    return torch.abs(ii - expected) <= radius


class ChromaSequenceSimilarity:
    """ChromaSequenceSimilarity.ComputeSimilarity
    (chroma_similarity.go:59-101). Defaults: binary threshold 0.4, gap
    penalty 0.1, OTI radius 10. A tensor input keeps its device; numpy
    input goes to `device`."""

    def __init__(
        self,
        method: str = "direct",
        binary_threshold: float = 0.4,
        gap_penalty: float = 0.1,
        dtw_band_radius: int = 0,
        transposition_invariant: bool = False,
        device: Device = DEFAULT_DEVICE,
    ):
        self.method = method
        self.binary_threshold = binary_threshold
        self.gap_penalty = gap_penalty
        self.dtw_band_radius = dtw_band_radius
        self.transposition_invariant = transposition_invariant
        self.device = device

    def compute(self, query, reference) -> ChromaSimilarityResult:
        q = as_float32(query, self.device)
        r = as_float32(reference, self.device).to(q.device)
        dispatch = {
            "direct": self._direct,
            "binary": self._binary,
            "smith_waterman": self._smith_waterman,
            "dtw": self._dtw,
            "qmax": self._qmax,
            "oti": self._oti,
        }
        if self.method not in dispatch:
            raise ValueError(f"unknown chroma similarity method {self.method}")
        return dispatch[self.method](q, r)

    # -- direct (:105-160) ------------------------------------------------
    def _direct(self, q, r) -> ChromaSimilarityResult:
        shift = 0
        if self.transposition_invariant:
            shift, _ = optimal_transposition(chroma_template(q), chroma_template(r))
            q = torch.roll(q, shift, dims=-1)
        sim = _cross_similarity_matrix(q, r)
        return ChromaSimilarityResult(
            sim.cpu().numpy(), float(torch.mean(sim)), "direct", shift,
            q.shape[0], r.shape[0],
        )

    # -- binary (:162-200) ---------------------------------------------------
    def _binary(self, q, r) -> ChromaSimilarityResult:
        direct = self._direct(q, r)
        binary = (direct.similarity_matrix > self.binary_threshold).astype(np.float32)
        return ChromaSimilarityResult(
            binary, float(binary.mean()), "binary", direct.best_transposition,
            q.shape[0], r.shape[0],
        )

    # -- Smith-Waterman (:202-270) --------------------------------------------
    def _smith_waterman(self, q, r) -> ChromaSimilarityResult:
        sim = _cross_similarity_matrix(q, r)
        gap = self.gap_penalty
        tq, tr = sim.shape
        # S[j] = max(a[j], S[j-1] - gap) = max_{i<=j}(a[i] + i gap) - j gap
        ramp = gap * torch.arange(tr, dtype=torch.float32, device=sim.device)
        rows = torch.empty((tq, tr), dtype=torch.float32, device=sim.device)
        prev = torch.zeros(tr + 1, dtype=torch.float32, device=sim.device)
        for i in range(tq):
            # S[j] = max(0, diag + sim, up - gap, S[j-1] - gap)
            a = torch.clamp_min(torch.maximum(prev[:-1] + sim[i], prev[1:] - gap), 0.0)
            s = torch.cummax(a + ramp, dim=0).values - ramp
            rows[i] = s
            prev = F.pad(s, (1, 0))
        max_score = float(torch.amax(rows))
        # normalize by the shorter sequence (alignment length proxy)
        norm = max_score / max(min(tq, tr), 1)
        return ChromaSimilarityResult(
            rows.cpu().numpy(), norm, "smith_waterman", 0, tq, tr
        )

    # -- DTW (:274-352) ----------------------------------------------------------
    def _dtw(self, q, r) -> ChromaSimilarityResult:
        from sonido_sonar_tpu_torch.ops.stats.dtw import _minplus_row_scan

        sim = _cross_similarity_matrix(q, r)
        cost = 1.0 - sim  # cosine distance matrix
        tq, tr = cost.shape
        big = float(np.float32(1e18))
        if self.dtw_band_radius > 0:
            # slanted band: |j - i*Tr/Tq| <= radius (chroma_similarity.go
            # band via expectedJ)
            cost = torch.where(dtw_band_mask(tq, tr, self.dtw_band_radius, cost.device), cost, big)
        prev = torch.full((tr + 1,), big, dtype=torch.float32, device=cost.device)
        prev[0] = 0.0
        capped = torch.clamp_max(cost, big)
        for i in range(tq):
            v = torch.minimum(prev[1:], prev[:-1])
            a = torch.clamp_max(cost[i] + v, big)
            d = _minplus_row_scan(a, capped[i])
            prev = F.pad(torch.clamp_max(d, big), (1, 0), value=big)
        total = float(prev[-1])
        path_len = max(tq, tr)  # proxy; reference normalizes by path length
        overall = float(np.exp(-(total / path_len)))
        return ChromaSimilarityResult(
            torch.exp(-cost).cpu().numpy(), overall, "dtw", 0, tq, tr
        )

    # -- QMax (:360-420) -----------------------------------------------------------
    def _qmax(self, q, r) -> ChromaSimilarityResult:
        sim = _cross_similarity_matrix(q, r).cpu().numpy()
        tq, tr = sim.shape
        diag_maxima = []
        for d in range(-(tr - 1), tq):
            diag = np.diagonal(sim, offset=-d)
            if len(diag):
                diag_maxima.append(diag.max())
        overall = float(np.mean(diag_maxima)) if diag_maxima else 0.0
        return ChromaSimilarityResult(sim, overall, "qmax", 0, tq, tr)

    # -- OTI (:422-450) ---------------------------------------------------------------
    def _oti(self, q, r) -> ChromaSimilarityResult:
        shift, _ = optimal_transposition(chroma_template(q), chroma_template(r))
        res = self._direct(torch.roll(q, shift, dims=-1), r)
        res.method = "oti"
        res.best_transposition = shift
        return res


# ---------------------------------------------------------------------
# Pitch-class relationships (pitch_class.go)
# ---------------------------------------------------------------------

CIRCLE_OF_FIFTHS = [0, 7, 2, 9, 4, 11, 6, 1, 8, 3, 10, 5]  # C G D A E B F# C# G# D# A# F


def fifths_distance(pc1: int, pc2: int) -> int:
    """Steps around the circle of fifths (pitch_class.go circle logic)."""
    i1 = CIRCLE_OF_FIFTHS.index(pc1 % 12)
    i2 = CIRCLE_OF_FIFTHS.index(pc2 % 12)
    d = abs(i1 - i2)
    return min(d, 12 - d)


def key_relationship(root1: int, mode1: str, root2: int, mode2: str) -> str:
    """Key relationship classification (pitch_class.go:27-200)."""
    if root1 == root2 and mode1 == mode2:
        return "identical"
    if root1 == root2:
        return "parallel"
    if mode1 == "major" and mode2 == "minor" and (root1 - root2) % 12 == 3:
        return "relative"
    if mode1 == "minor" and mode2 == "major" and (root2 - root1) % 12 == 3:
        return "relative"
    if mode1 == mode2 and (root2 - root1) % 12 in (5, 7):
        return "dominant" if (root2 - root1) % 12 == 7 else "subdominant"
    if fifths_distance(root1, root2) <= 2:
        return "close"
    return "distant"


_MAJOR_SCALE = {0, 2, 4, 5, 7, 9, 11}


def diatonic_membership(pc: int, key_root: int, mode: str = "major") -> bool:
    """Is pitch class diatonic to the key? (pitch_class.go diatonic)."""
    rel = (pc - key_root) % 12
    if mode == "major":
        return rel in _MAJOR_SCALE
    return rel in {0, 2, 3, 5, 7, 8, 10}  # natural minor


def transposition_search(profile: torch.Tensor, target: torch.Tensor) -> Tuple[int, float]:
    """Best transposition of profile onto target (pitch_class.go
    transposition search)."""
    return optimal_transposition(profile, target, "cosine")


# ---------------------------------------------------------------------
# Tonnetz (tonnetz.go)
# ---------------------------------------------------------------------

def _tonnetz_lattice_coords() -> np.ndarray:
    """Reference 2-D lattice (tonnetz.go:47-107): x = circle-of-fifths
    position, y in sqrt(3)/2 steps by major-third class."""
    fifths_x = {0: 0, 7: 1, 2: 2, 9: 3, 4: 4, 11: 5, 6: 6,
                1: -5, 8: -4, 3: -3, 10: -2, 5: -1}
    y_groups = {
        (4, 8, 0): 0.0,
        (7, 11, 3): np.sqrt(3.0) / 2.0,
        (10, 2, 6): -np.sqrt(3.0) / 2.0,
        (1, 5, 9): np.sqrt(3.0),
    }
    coords = np.zeros((12, 2))
    for pc in range(12):
        coords[pc, 0] = fifths_x[pc]
        for group, y in y_groups.items():
            if pc in group:
                coords[pc, 1] = y
    return coords


TONNETZ_LATTICE = _tonnetz_lattice_coords()


def _tonal_centroid_matrix() -> np.ndarray:
    """Standard 6-d tonal centroid transform [6, 12] (fifths r=1,
    minor thirds r=1, major thirds r=0.5 circles)."""
    pc = np.arange(12)
    t = np.zeros((6, 12))
    t[0] = np.sin(pc * 7 * np.pi / 6.0)
    t[1] = np.cos(pc * 7 * np.pi / 6.0)
    t[2] = np.sin(pc * 3 * np.pi / 2.0)
    t[3] = np.cos(pc * 3 * np.pi / 2.0)
    t[4] = 0.5 * np.sin(pc * 2 * np.pi / 3.0)
    t[5] = 0.5 * np.cos(pc * 2 * np.pi / 3.0)
    return t.astype(np.float32)


_TONAL_CENTROID = _tonal_centroid_matrix()
_CONSONANT_INTERVALS = {0: 1.0, 7: 0.9, 5: 0.8, 4: 0.7, 3: 0.7, 8: 0.6, 9: 0.6}
_DISSONANT_INTERVALS = {1: 0.9, 11: 0.9, 6: 0.8, 2: 0.5, 10: 0.5}


def _interval_weights(consonant: bool) -> np.ndarray:
    """[12, 12] weight of the interval (j - i) mod 12."""
    table = _CONSONANT_INTERVALS if consonant else _DISSONANT_INTERVALS
    out = np.zeros((12, 12), dtype=np.float32)
    for i in range(12):
        for j in range(12):
            out[i, j] = table.get((j - i) % 12, 0.0)
    return out


def _lattice_f32() -> np.ndarray:
    return TONNETZ_LATTICE.astype(np.float32)


def _tonal_centroid_t() -> np.ndarray:
    return _TONAL_CENTROID.T


def tonal_centroid(chroma: torch.Tensor) -> torch.Tensor:
    """6-d tonal centroid per frame, [..., 12] -> [..., 6]."""
    total = torch.sum(torch.abs(chroma), dim=-1, keepdim=True)
    normed = torch.where(total > _EPS, chroma / torch.clamp_min(total, _EPS), chroma)
    return torch.matmul(normed, device_table(_tonal_centroid_t, (), chroma.device))


def tonnetz_point(chroma: torch.Tensor) -> torch.Tensor:
    """Weighted 2-D lattice centroid (tonnetz.go ComputeTonnetz),
    [..., 12] -> [..., 2]."""
    total = torch.sum(chroma, dim=-1, keepdim=True)
    w = torch.where(total > _EPS, chroma / torch.clamp_min(total, _EPS), chroma)
    return torch.matmul(w, device_table(_lattice_f32, (), chroma.device))


def tonnetz_trajectory(chroma_seq: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Trajectory/movement analysis (tonnetz.go:200-330): per-frame
    centroid, step distances, total path length, mean speed."""
    pts = tonal_centroid(chroma_seq)  # [T, 6]
    steps = torch.linalg.vector_norm(pts[1:] - pts[:-1], dim=-1)
    return {
        "centroids": pts,
        "step_distances": steps,
        "path_length": torch.sum(steps),
        "mean_speed": torch.mean(steps) if steps.shape[0] else steps.new_zeros(()),
        "stability": 1.0 / (1.0 + torch.mean(steps)),
    }


def _interval_energy(chroma: torch.Tensor, consonant: bool) -> torch.Tensor:
    c = chroma / torch.clamp_min(torch.sum(chroma, dim=-1, keepdim=True), _EPS)
    w = device_table(_interval_weights, (consonant,), chroma.device)
    return torch.einsum("...i,ij,...j->...", c, w, c)


def harmonic_tension(chroma: torch.Tensor) -> torch.Tensor:
    """Pairwise interval dissonance weighted by chroma energy
    (tonnetz.go tension :350-420)."""
    return _interval_energy(chroma, consonant=False)


def consonance(chroma: torch.Tensor) -> torch.Tensor:
    """Complement measure with consonant interval weights
    (tonnetz.go consonance)."""
    return _interval_energy(chroma, consonant=True)


def voice_leading_distance(chroma1: torch.Tensor, chroma2: torch.Tensor) -> torch.Tensor:
    """Minimal total pitch-class movement between two chroma
    distributions (tonnetz.go voice leading :480-565) — 1-D circular EMD
    approximated by the best-rotation linear EMD: the median of the 12
    cumulative differences (the mean of the middle two)."""
    p = chroma1 / torch.clamp_min(torch.sum(chroma1, dim=-1, keepdim=True), _EPS)
    q = chroma2 / torch.clamp_min(torch.sum(chroma2, dim=-1, keepdim=True), _EPS)
    c = torch.cumsum(p - q, dim=-1)
    k = median(c, keepdim=True)
    return torch.sum(torch.abs(c - k), dim=-1)
