"""Device-side batched fingerprint comparator (counterpart of
`sonido_sonar_tpu/fingerprint/device_compare.py`).

The reference compares fingerprints one pair at a time on the host
(comparison.go:133-194) and FindBestMatches/BatchCompare loop Compare()
over candidates (comparison.go:197-263, 1107-1151). Every live term of
that scoring chain operates on fixed-size per-feature *statistics* —
cosines of stats vectors, scalar ratios, a weighted mean, a confidence
heuristic — so a corpus packs into one [C, D] matrix and the whole
chain becomes elementwise and reduction passes over the candidate axis:
one call scores any number of candidates.

Parity contract: `batched_similarity` reproduces
FingerprintComparator.compare with enable_detailed_metrics=False (the
default, and the FindBestMatches configuration):
  - per-feature sims: MFCC stats-cosine (comparison.go:344-401),
    spectral per-series (mean, std) cosines averaged (:646-671),
    chroma mean-vector cosine (:673-688), temporal/speech/harmonic
    scalar ratios + sequence stats (:690-770)
  - weighted mean over present features (:875-882, 1055-1104)
  - OverallSimilarity = FeatureSimilarity (:886-889, quirk #4)
  - confidence heuristic without quality terms (:1011-1037)
  - match classes (:1040-1052)
  - content filter early-out (:160-166): zero similarity, 0.0
    confidence, "weak"
to utils/parity.COMPARATOR_HOST_ATOL (float32 device math against the
float64 host), and the JAX package's device functions to
COMPARATOR_PORT_ATOL (tests/test_torch_device_compare.py).

Packing one fingerprint runs on the host in float64 (once per corpus);
a batch from the generator packs on its own device
(`pack_comparator_stats_batch`). Device placement: the corpus decides.
A tensor corpus stays on its device and the small per-query inputs
follow it; a numpy corpus goes to `device` (the card unless the caller
asks for the CPU). On a card the selector matmuls need true float32
(`utils/device.require_fp32_matmuls`). Top-k selection is a stable
descending sort, so equal scores come out lowest index first, as JAX's
exact `approx_max_k` gives them. No pass here reaches a kernel written
for the TPU: JAX leaves the chain to XLA, and the port to PyTorch.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sonido_sonar_tpu_torch.config.config import ContentType
from sonido_sonar_tpu_torch.fingerprint.comparison import (
    _CONTENT_WEIGHTS,
    _DEFAULT_WEIGHTS,
    _copy_to_host_async,
    _size,
    _to_np,
    extract_mfcc_statistics,
)
from sonido_sonar_tpu_torch.fingerprint.generator import AudioFingerprint
from sonido_sonar_tpu_torch.utils.convert import flatten_features
from sonido_sonar_tpu_torch.utils.device import DEFAULT_DEVICE, Device, require_fp32_matmuls

_EPS = 1e-10

# feature order shared by the packed layout and the weight vector
FEATURE_ORDER = ("mfcc", "spectral", "chroma", "temporal", "speech", "harmonic")

# match classes, indexed by the bucket the scoring pass emits
MATCH_CLASSES = ("weak", "somewhat_similar", "similar", "very_similar", "exact")


def layout_size(num_mfcc_coeffs: int) -> int:
    """Packed vector width D for a given MFCC coefficient count."""
    return 44 + 2 * num_mfcc_coeffs


def _offsets(num_mfcc_coeffs: int) -> Dict[str, int]:
    a = 6 + 2 * num_mfcc_coeffs      # end of mfcc stats
    b = a + 9                        # end of spectral block
    c = b + 12                       # end of chroma block
    d = c + 6                        # end of temporal block
    e = d + 5                        # end of speech block
    return {"mfcc": 6, "spectral": a, "chroma": b, "temporal": c,
            "speech": d, "harmonic": e}


def pack_comparator_stats(fp: AudioFingerprint, num_mfcc_coeffs: int = 13) -> np.ndarray:
    """Pack one fingerprint's full comparator statistics into a [D]
    float32 vector (layout documented in _offsets/layout_size).

    All reductions run in float64 on host, matching the host comparator
    bit-for-bit before the final float32 cast. Leaves may be tensors on
    any device (read through comparison._to_np).
    """
    f = fp.features
    D = layout_size(num_mfcc_coeffs)
    v = np.zeros(D, dtype=np.float64)
    off = _offsets(num_mfcc_coeffs)

    def seq_stats(x) -> Tuple[float, float, float]:
        """(mean, sample std, present) of a 1-D series."""
        if x is None:
            return 0.0, 0.0, 0.0
        s = _to_np(x).ravel()
        if s.size == 0:
            return 0.0, 0.0, 0.0
        std = float(np.sqrt(s.var(ddof=1))) if s.size > 1 else 0.0
        return float(s.mean()), std, 1.0

    if f.mfcc is not None and _size(f.mfcc) > 0:
        mfcc = _to_np(f.mfcc)
        if mfcc.shape[-1] != num_mfcc_coeffs:
            raise ValueError(
                f"fingerprint {fp.id} has {mfcc.shape[-1]} MFCC "
                f"coefficients, layout expects {num_mfcc_coeffs}"
            )
        v[0] = 1.0
        v[off["mfcc"]: off["mfcc"] + 2 * num_mfcc_coeffs] = extract_mfcc_statistics(mfcc)

    sf = f.spectral_features
    if sf is not None:
        v[1] = 1.0
        base = off["spectral"]
        for i, series in enumerate((sf.spectral_centroid, sf.spectral_rolloff, sf.spectral_flux)):
            m, s, p = seq_stats(series)
            v[base + 2 * i] = m
            v[base + 2 * i + 1] = s
            v[base + 6 + i] = p

    if f.chroma_features is not None:
        ch = _to_np(f.chroma_features)
        if ch.size:
            v[2] = 1.0
            v[off["chroma"]: off["chroma"] + 12] = ch.mean(axis=0)[:12]

    def scalar(x) -> float:
        return float(x) if x is not None else 0.0

    tf = f.temporal_features
    if tf is not None:
        v[3] = 1.0
        base = off["temporal"]
        v[base + 0] = scalar(tf.dynamic_range)
        v[base + 1] = scalar(tf.silence_ratio)
        v[base + 2] = scalar(tf.onset_density)
        m, s, p = seq_stats(tf.rms_energy)
        v[base + 3], v[base + 4], v[base + 5] = m, s, p

    sp = f.speech_features
    if sp is not None:
        v[4] = 1.0
        base = off["speech"]
        v[base + 0] = scalar(sp.speech_rate)
        v[base + 1] = scalar(sp.vocal_tract_length)
        m, s, p = seq_stats(sp.voicing_probability)
        v[base + 2], v[base + 3], v[base + 4] = m, s, p

    hf = f.harmonic_features
    if hf is not None:
        v[5] = 1.0
        base = off["harmonic"]
        m, s, p = seq_stats(hf.harmonic_ratio)
        v[base + 0], v[base + 1], v[base + 2] = m, s, p
        m, s, p = seq_stats(hf.pitch_estimate)
        v[base + 3], v[base + 4], v[base + 5] = m, s, p

    return v.astype(np.float32)


def comparator_matrix(
    fps: List[AudioFingerprint], num_mfcc_coeffs: Optional[int] = None
) -> Tuple[np.ndarray, int]:
    """[C, D] packed corpus matrix (host numpy) + the MFCC width used."""
    if num_mfcc_coeffs is None:
        num_mfcc_coeffs = 13
        for fp in fps:
            if fp.features is not None and fp.features.mfcc is not None:
                num_mfcc_coeffs = int(np.shape(fp.features.mfcc)[-1])
                break
    return (
        np.stack([pack_comparator_stats(fp, num_mfcc_coeffs) for fp in fps]),
        num_mfcc_coeffs,
    )


def _present(x) -> bool:
    return x is not None and x.numel() > 0


def pack_comparator_stats_batch(features, num_mfcc_coeffs: int = 13) -> torch.Tensor:
    """pack_comparator_stats over a batched ExtractedFeatures ([B, ...]
    tensors) -> [B, D] float32 on the features' device: the corpus-ready
    path for generate_fingerprints_batch (the features never leave the
    device; only this small matrix, or nothing, is fetched).

    A field that is absent leaves its slots zero, as in the host packer.
    Sequence stats reduce over the trailing (time) axis in float32, the
    host's per-clip ravel for the 1-D series this layout packs, and a
    one-frame series has std 0 (not torch.var's NaN), as on the host.
    Parity against the host packer: utils/parity.COMPARATOR_PACK_SCALED_ATOL.
    """
    f = features
    leaves = [v for v in flatten_features(f).values() if v.dim() >= 1]
    if not leaves:
        raise ValueError("no packable features in batch")
    b, dev = leaves[0].shape[0], leaves[0].device
    D = layout_size(num_mfcc_coeffs)
    off = _offsets(num_mfcc_coeffs)
    zero = torch.zeros(b, dtype=torch.float32, device=dev)
    one = torch.ones(b, dtype=torch.float32, device=dev)
    cols: List[torch.Tensor] = [zero] * D

    def std(x: torch.Tensor, dim: int) -> torch.Tensor:
        if x.shape[dim] > 1:
            return x.var(dim=dim, correction=1).sqrt()
        return torch.zeros_like(x.select(dim, 0))

    def seq(x: torch.Tensor):
        """(mean, sample std) over the trailing (time) axis of [B, T]."""
        x = x.to(torch.float32)
        return x.mean(dim=-1), std(x, -1)

    if _present(f.mfcc):
        mfcc = f.mfcc.to(torch.float32)  # [B, T, C]
        if mfcc.shape[-1] != num_mfcc_coeffs:
            raise ValueError(
                f"batch has {mfcc.shape[-1]} MFCC coefficients, layout expects {num_mfcc_coeffs}"
            )
        cols[0] = one
        means, stds = mfcc.mean(dim=-2), std(mfcc, -2)
        for c in range(num_mfcc_coeffs):
            cols[off["mfcc"] + c] = means[:, c]
            cols[off["mfcc"] + num_mfcc_coeffs + c] = stds[:, c]

    sf = f.spectral_features
    if sf is not None:
        cols[1] = one
        base = off["spectral"]
        for i, series in enumerate((sf.spectral_centroid, sf.spectral_rolloff, sf.spectral_flux)):
            if _present(series):
                cols[base + 2 * i], cols[base + 2 * i + 1] = seq(series)
                cols[base + 6 + i] = one

    if _present(f.chroma_features):
        cols[2] = one
        ch_mean = f.chroma_features.to(torch.float32).mean(dim=-2)  # [B, 12]
        for i in range(12):
            cols[off["chroma"] + i] = ch_mean[:, i]

    tf = f.temporal_features
    if tf is not None:
        cols[3] = one
        base = off["temporal"]
        for j, x in enumerate((tf.dynamic_range, tf.silence_ratio, tf.onset_density)):
            if x is not None:
                cols[base + j] = x.to(torch.float32)
        if _present(tf.rms_energy):
            cols[base + 3], cols[base + 4] = seq(tf.rms_energy)
            cols[base + 5] = one

    sp = f.speech_features
    if sp is not None:
        cols[4] = one
        base = off["speech"]
        for j, x in enumerate((sp.speech_rate, sp.vocal_tract_length)):
            if x is not None:
                cols[base + j] = x.to(torch.float32)
        if _present(sp.voicing_probability):
            cols[base + 2], cols[base + 3] = seq(sp.voicing_probability)
            cols[base + 4] = one

    hf = f.harmonic_features
    if hf is not None:
        cols[5] = one
        base = off["harmonic"]
        for j, x in enumerate((hf.harmonic_ratio, hf.pitch_estimate)):
            if _present(x):
                cols[base + 3 * j], cols[base + 3 * j + 1] = seq(x)
                cols[base + 3 * j + 2] = one

    return torch.stack(cols, dim=-1)


def content_code(ct) -> int:
    """Stable integer code per ContentType (its position in the enum),
    shared by every content-match path."""
    return {c: i for i, c in enumerate(ContentType)}.get(ct, -1)


def _tensor(x, dev: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`x` as a tensor on `dev`: a tensor moved there, numpy uploaded
    without a wait on a card (pinned, non-blocking)."""
    if isinstance(x, torch.Tensor):
        t = x.to(dev, non_blocking=dev.type == "cuda")
    else:
        t = torch.as_tensor(np.array(x))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
    return t if dtype is None else t.to(dtype)


def _device_of(corpus, device: Device) -> torch.device:
    """Where a pass over `corpus` runs: a tensor's own device, else
    `device`."""
    return corpus.device if isinstance(corpus, torch.Tensor) else torch.device(device)


class PackedCorpus:
    """A corpus packed once for repeated device search.

    The reference re-walks every candidate per FindBestMatches call
    (comparison.go:197-263). A monitor searches the same corpus for
    every measurement, so packing is hoisted here: build once (host
    packer, or on the device from a FingerprintBatch), then every
    `FingerprintComparator.search_corpus` call is one scoring and top-k
    pass and a [k]-row fetch.
    """

    def __init__(self, fingerprints, matrix: torch.Tensor, codes: torch.Tensor, width: int):
        self.fingerprints = fingerprints
        self.matrix = matrix          # [C, D] float32 on a device
        self.codes = codes            # [C] int32 on the same device
        self.width = width

    def __len__(self) -> int:
        return len(self.fingerprints)

    @classmethod
    def build(cls, fingerprints, num_mfcc_coeffs: Optional[int] = None,
              device: Device = DEFAULT_DEVICE) -> "PackedCorpus":
        """Pack host-side fingerprints (float64 host packer, once) and put
        the matrix and codes on `device`."""
        fps = [fp for fp in fingerprints if fp is not None]
        matrix, width = comparator_matrix(fps, num_mfcc_coeffs)
        codes = np.array([content_code(fp.content_type) for fp in fps], np.int32)
        dev = torch.device(device)
        return cls(fps, _tensor(matrix, dev), _tensor(codes, dev), width)

    @classmethod
    def from_batch(cls, batch, num_mfcc_coeffs: int = 13) -> "PackedCorpus":
        """Pack a FingerprintBatch on the device its features live on,
        without the features leaving it
        (generator.FingerprintBatch.comparator_matrix)."""
        matrix = batch.comparator_matrix(num_mfcc_coeffs)
        codes = np.array([content_code(fp.content_type) for fp in batch.fingerprints], np.int32)
        return cls(list(batch.fingerprints), matrix, _tensor(codes, matrix.device), num_mfcc_coeffs)


def pack_quality_extras(
    fp: AudioFingerprint, max_frames: int
) -> Tuple[np.ndarray, float, np.ndarray, np.ndarray]:
    """Per-fingerprint inputs of calculateQualityMetrics
    (comparison.go:892-1008) that the stats layout doesn't carry:

      avail  [6] float32 — not-None bits per feature group (the host's
              data-availability test is `is not None`, NOT non-empty)
      duration scalar (seconds)
      series [2, max_frames] float32 — spectral centroid + rolloff
              time series, zero-padded (spectral coherence needs the
              raw series, not summary stats)
      lengths [2] int32 — true series lengths (0 = series absent)
    """
    f = fp.features
    avail = np.array(
        [
            f.mfcc is not None,
            f.spectral_features is not None,
            f.chroma_features is not None,
            f.temporal_features is not None,
            f.speech_features is not None,
            f.harmonic_features is not None,
        ],
        dtype=np.float32,
    )
    series = np.zeros((2, max_frames), dtype=np.float32)
    lengths = np.zeros(2, dtype=np.int32)
    sf = f.spectral_features
    if sf is not None:
        for i, s in enumerate((sf.spectral_centroid, sf.spectral_rolloff)):
            if s is None:
                continue
            s = _to_np(s).astype(np.float32).ravel()[:max_frames]
            series[i, : s.size] = s
            lengths[i] = s.size
    return avail, float(fp.duration), series, lengths


def quality_matrix(
    fps: List[AudioFingerprint], max_frames: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Stack pack_quality_extras over a corpus:
    ([C, 6] avail, [C] durations, [C, 2, T] series, [C, 2] lengths)."""
    if max_frames is None:
        max_frames = 1
        for fp in fps:
            sf = fp.features.spectral_features if fp.features else None
            if sf is not None:
                for s in (sf.spectral_centroid, sf.spectral_rolloff):
                    if s is not None:
                        max_frames = max(max_frames, int(_size(s)))
    packed = [pack_quality_extras(fp, max_frames) for fp in fps]
    return (
        np.stack([p[0] for p in packed]),
        np.array([p[1] for p in packed], dtype=np.float32),
        np.stack([p[2] for p in packed]),
        np.stack([p[3] for p in packed]),
    )


def content_weight_vector(content_type: ContentType) -> np.ndarray:
    """[6] weight vector in FEATURE_ORDER for getEffectiveWeights
    (comparison.go:1055-1104)."""
    table = _CONTENT_WEIGHTS.get(content_type, _DEFAULT_WEIGHTS)
    return np.array([table.get(k, 0.0) for k in FEATURE_ORDER], dtype=np.float32)


# ---------------------------------------------------------------------
# the scoring passes
# ---------------------------------------------------------------------

def _segment_selectors(num_mfcc_coeffs: int):
    """Static metadata for the segment-matmul formulation of the scoring
    chain: a [D, 9] 0/1 selection matrix (one column per dot/norm
    segment of the packed layout — mfcc stats, 3 spectral series,
    chroma, temporal rms, voicing, 2 harmonic), the presence/gate column
    indices, and the scalar-feature column indices.

    All nine dot products and squared norms ride two [C, D] x [D, 9]
    matmuls over 0/1 selectors, and everything downstream runs on
    [C, <=13] tiles instead of ~40 column slices of the corpus."""
    off = _offsets(num_mfcc_coeffs)
    D = layout_size(num_mfcc_coeffs)
    a, b, c, d, e = (off["spectral"], off["chroma"], off["temporal"],
                     off["speech"], off["harmonic"])
    # groups 1-3 and 5-8 are the (mean, std) 2-vectors of
    # compareSequenceStats (comparison.go:826-841) — their cosine is the
    # same segment dot/norm computation as the wide mfcc/chroma blocks
    groups = (
        (off["mfcc"], off["mfcc"] + 2 * num_mfcc_coeffs),  # 0 mfcc stats
        (a, a + 2), (a + 2, a + 4), (a + 4, a + 6),        # 1-3 spectral series
        (b, b + 12),                                       # 4 chroma mean
        (c + 3, c + 5),                                    # 5 temporal rms stats
        (d + 2, d + 4),                                    # 6 speech voicing stats
        (e, e + 2), (e + 3, e + 5),                        # 7-8 harmonic stats
    )
    sel = np.zeros((D, len(groups)), dtype=np.float32)
    for g, (lo, hi) in enumerate(groups):
        sel[lo:hi, g] = 1.0
    # gate columns: 6 group-present bits, 3 spectral series bits,
    # temporal rms bit, speech voicing bit, 2 harmonic bits
    gate_cols = np.array(
        [0, 1, 2, 3, 4, 5, a + 6, a + 7, a + 8, c + 5, d + 4, e + 2, e + 5],
        dtype=np.int32,
    )
    # scalar-feature columns: dynamic range, silence, onset density,
    # speech rate, vocal tract length
    scalar_cols = np.array([c, c + 1, c + 2, d, d + 1], dtype=np.int32)
    return sel, gate_cols, scalar_cols


@functools.lru_cache(maxsize=8)
def _device_selectors(num_mfcc_coeffs: int, dev: torch.device):
    """_segment_selectors as tensors on `dev`, uploaded once per (width,
    device)."""
    sel, gate_cols, scalar_cols = _segment_selectors(num_mfcc_coeffs)
    return (_tensor(sel, dev), _tensor(gate_cols, dev, torch.int64),
            _tensor(scalar_cols, dev, torch.int64))


def _cosine(dot, n1, n2):
    """cosineSimilarity gating (comparison.go:858-873): zero norm -> 0."""
    return torch.where((n1 > 0) & (n2 > 0), dot / torch.clamp_min(n1 * n2, _EPS), 0.0)


def _scalar_sim(v1, v2):
    """compareScalarFeatures (comparison.go:843-856)."""
    maxv = torch.maximum(v1.abs(), v2.abs())
    sim = torch.clamp_min(1.0 - (v1 - v2).abs() / torch.clamp_min(maxv, _EPS), 0.0)
    return torch.where(maxv == 0.0, 1.0, sim)


def _gated_mean(acc, cnt):
    return torch.where(cnt > 0, acc / torch.clamp_min(cnt, 1.0), 0.0)


def _feature_sims(cos, gate, ssim, gq_s, gx_s, axis: int):
    """The six per-feature similarities from the segment cosines `cos`
    (9 along `axis`), the gates `gate` (13), the scalar sims `ssim` (5)
    and the scalar columns of the query and candidates (`gq_s`, `gx_s`,
    5 along `axis`, broadcastable): stacked along `axis`."""
    def at(x, i):
        return x.select(axis, i)

    def pos(i):
        return (at(gq_s, i) > 0) & (at(gx_s, i) > 0)

    def f32(x):
        return x.to(torch.float32)

    sims = [at(cos, 0)]                                        # mfcc
    g = gate.narrow(axis, 6, 3)                                # spectral
    acc = torch.where(g, cos.narrow(axis, 1, 3), 0.0).sum(dim=axis)
    sims.append(_gated_mean(acc, f32(g).sum(dim=axis)))
    sims.append(at(cos, 4))                                    # chroma
    g_dr, g_od, g_rms = pos(0), pos(2), at(gate, 9)            # temporal
    acc = (torch.where(g_dr, at(ssim, 0), 0.0) + at(ssim, 1)
           + torch.where(g_od, at(ssim, 2), 0.0) + torch.where(g_rms, at(cos, 5), 0.0))
    cnt = f32(g_dr) + 1.0 + f32(g_od) + f32(g_rms)
    sims.append(acc / torch.clamp_min(cnt, 1.0))
    g_rate, g_vtl, g_voice = pos(3), pos(4), at(gate, 10)      # speech
    acc = (torch.where(g_rate, at(ssim, 3), 0.0) + torch.where(g_vtl, at(ssim, 4), 0.0)
           + torch.where(g_voice, at(cos, 6), 0.0))
    sims.append(_gated_mean(acc, f32(g_rate) + f32(g_vtl) + f32(g_voice)))
    g_h1, g_h2 = at(gate, 11), at(gate, 12)                    # harmonic
    acc = torch.where(g_h1, at(cos, 7), 0.0) + torch.where(g_h2, at(cos, 8), 0.0)
    sims.append(_gated_mean(acc, f32(g_h1) + f32(g_h2)))
    return torch.stack(sims, dim=axis)


def _overall(feature_sims, feature_present, weights, content_match, content_filter: bool, axis: int):
    """(overall, confidence without quality terms, match_class, keep,
    n_present): the weighted mean over present features
    (comparison.go:875-882; a zero weight sum falls back to the plain
    mean, as the host does), the content filter, the confidence
    heuristic (:1011-1037) and the match buckets (:1040-1052)."""
    p = feature_present.to(torch.float32)
    wmask = p * weights
    wsum = wmask.sum(dim=axis)
    n_present = p.sum(dim=axis)
    weighted = (feature_sims * wmask).sum(dim=axis) / torch.clamp_min(wsum, _EPS)
    unweighted = (feature_sims * p).sum(dim=axis) / torch.clamp_min(n_present, 1.0)
    overall = torch.where(wsum > 0, weighted, unweighted)
    keep = content_match if content_filter else torch.ones_like(content_match)
    overall = torch.where(keep, overall, 0.0)
    confidence = torch.where(keep, torch.clamp(_base_confidence(overall, content_match, n_present),
                                               0.0, 1.0), 0.0)
    match_class = sum((overall >= t).to(torch.int32) for t in (0.6, 0.75, 0.85, 0.95))
    match_class = torch.where(keep, match_class, 0).to(torch.int32)
    return overall, confidence, match_class, keep, n_present


def _base_confidence(overall, content_match, n_present):
    """calculateConfidence before the [0, 1] clip and the quality terms
    (comparison.go:1011-1037)."""
    return (
        0.5
        + torch.where(overall > 0.8, 0.3, torch.where(overall > 0.6, 0.2, 0.0))
        + torch.where(content_match, 0.1, 0.0)
        + n_present * 0.05
    )


def batched_similarity(
    query,                         # [D]
    corpus,                        # [C, D]
    weights,                       # [6] per-content weights of the query
    content_match,                 # [C] bool
    num_mfcc_coeffs: int = 13,
    content_filter: bool = False,
    device: Device = DEFAULT_DEVICE,
) -> Dict[str, torch.Tensor]:
    """The full live comparator chain for one query against C packed
    candidates, on the corpus's device. Returns dict with overall [C],
    confidence [C], match_class [C] int32 (index into MATCH_CLASSES),
    feature_sims [C, 6] and feature_present [C, 6] bool (both in
    FEATURE_ORDER).

    All nine dot products / squared norms of the chain ride two
    [C, D] x [D, 9] selector matmuls in true float32 (JAX's
    Precision.HIGHEST; these carry the MFCC/chroma cosines, where TF32
    would add ~1e-3), then the gated means run on [C, <=13] tiles."""
    dev = _device_of(corpus, device)
    X = _tensor(corpus, dev, torch.float32)
    require_fp32_matmuls(X, "batched_similarity")
    q = _tensor(query, dev, torch.float32)
    w = _tensor(weights, dev, torch.float32)
    cm = _tensor(content_match, dev, torch.bool)
    sel, gate_cols, scalar_cols = _device_selectors(num_mfcc_coeffs, dev)

    dots = (X * q[None, :]) @ sel                          # [C, 9]
    sq_x = (X * X) @ sel                                   # [C, 9]
    sq_q = (q * q) @ sel                                   # [9]
    cos = _cosine(dots, sq_x.sqrt(), sq_q.sqrt()[None, :])

    Xg, qg = X.index_select(1, gate_cols), q.index_select(0, gate_cols)
    gate = (qg[None, :] > 0) & (Xg > 0)                    # [C, 13]
    Xs, qs = X.index_select(1, scalar_cols), q.index_select(0, scalar_cols)
    ssim = _scalar_sim(qs[None, :], Xs)                    # [C, 5]

    feature_sims = _feature_sims(cos, gate, ssim, qs[None, :], Xs, axis=-1)  # [C, 6]
    feature_present = gate[:, :6]
    overall, confidence, match_class, keep, _ = _overall(
        feature_sims, feature_present, w[None, :], cm, content_filter, axis=-1)
    return {
        "overall": overall,
        "confidence": confidence,
        "match_class": match_class,
        "feature_sims": torch.where(keep[:, None], feature_sims, 0.0),
        "feature_present": feature_present & keep[:, None],
    }


def _stable_topk(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, equal
    scores lowest index first (a stable descending sort; torch.topk
    promises no order among ties)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_similarity(
    query,                         # [D]
    corpus,                        # [C, D]
    weights,                       # [6]
    content_match,                 # [C] bool
    k: int,
    num_mfcc_coeffs: int = 13,
    content_filter: bool = False,
    device: Device = DEFAULT_DEVICE,
) -> Dict[str, torch.Tensor]:
    """batched_similarity + exact top-k selection on the device, so a
    single query over a corpus fetches k rows instead of five [C]
    arrays.

    Returns index (int32)/overall/confidence/match_class [k],
    feature_sims/feature_present [k, 6] and content_match [k], ordered by
    descending overall similarity, ties lowest index first."""
    dev = _device_of(corpus, device)
    cm = _tensor(content_match, dev, torch.bool)
    out = batched_similarity(query, corpus, weights, cm, num_mfcc_coeffs=num_mfcc_coeffs,
                             content_filter=content_filter, device=dev)
    vals, idx = _stable_topk(out["overall"], min(k, out["overall"].shape[0]))
    return {
        "index": idx.to(torch.int32),
        "overall": vals,
        "confidence": out["confidence"][idx],
        "match_class": out["match_class"][idx],
        "feature_sims": out["feature_sims"][idx],
        "feature_present": out["feature_present"][idx],
        "content_match": cm[idx],
    }


def topk_similarity_multi(
    queries,                       # [Q, D]
    corpus,                        # [C, D]
    weights,                       # [Q, 6]
    q_content,                     # [Q] int32
    c_content,                     # [C] int32
    k: int,
    num_mfcc_coeffs: int = 13,
    content_filter: bool = False,
    device: Device = DEFAULT_DEVICE,
) -> Dict[str, torch.Tensor]:
    """Fleet top-k: Q queries x C candidates scored and selected in one
    pass; the fetch is [Q, k] rows instead of [Q, C] matrices. Row i
    equals topk_similarity of query i."""
    dev = _device_of(corpus, device)
    qc, cc = _tensor(q_content, dev, torch.int32), _tensor(c_content, dev, torch.int32)
    out = batched_similarity_multi(queries, corpus, weights, qc, cc,
                                   num_mfcc_coeffs=num_mfcc_coeffs,
                                   content_filter=content_filter, return_feature_sims=True,
                                   device=dev)
    vals, idx = _stable_topk(out["overall"], min(k, out["overall"].shape[-1]))

    def rows(x):
        return torch.take_along_dim(x, idx[:, :, None], dim=1)

    return {
        "index": idx.to(torch.int32),
        "overall": vals,
        "confidence": torch.take_along_dim(out["confidence"], idx, dim=-1),
        "match_class": torch.take_along_dim(out["match_class"], idx, dim=-1),
        "feature_sims": rows(out["feature_sims"]),
        "feature_present": rows(out["feature_present"]),
        "content_match": qc[:, None] == cc[idx],
    }


def batched_similarity_multi(
    queries,                       # [Q, D]
    corpus,                        # [C, D]
    weights,                       # [Q, 6] per-query content weights
    q_content,                     # [Q] int32 content codes
    c_content,                     # [C] int32 content codes
    num_mfcc_coeffs: int = 13,
    content_filter: bool = False,
    return_feature_sims: bool = True,
    device: Device = DEFAULT_DEVICE,
) -> Dict[str, torch.Tensor]:
    """Q queries scored against C packed candidates in one pass — the
    corpus-search shape for a fleet of live streams (the reference runs
    FindBestMatches per stream in its worker pool,
    comparison.go:197-263).

    All Q*9 segment dot products ride one [Q*9, D] x [D, C] float32
    matmul (the per-query selector expansion W[i,g,j] = Q[i,j]*sel[j,g]
    is built on the device, [Q*9, D] is small); candidate norms are
    shared across queries. Content matching runs from integer codes.

    Returns overall/confidence [Q, C], match_class [Q, C] int32, and —
    when return_feature_sims is set — feature_sims [Q, C, 6] /
    feature_present [Q, C, 6]. Row i equals batched_similarity(row i)."""
    dev = _device_of(corpus, device)
    X = _tensor(corpus, dev, torch.float32)
    require_fp32_matmuls(X, "batched_similarity_multi")
    Q = _tensor(queries, dev, torch.float32)
    w = _tensor(weights, dev, torch.float32)
    qc, cc = _tensor(q_content, dev, torch.int32), _tensor(c_content, dev, torch.int32)
    sel, gate_cols, scalar_cols = _device_selectors(num_mfcc_coeffs, dev)
    nq = Q.shape[0]

    Xt = X.T                                               # [D, C]
    W = (Q[:, None, :] * sel.T[None, :, :]).reshape(nq * 9, -1)   # [Q*9, D]
    dots = (W @ Xt).reshape(nq, 9, -1)                     # [Q, 9, C]
    sq_x = sel.T @ (Xt * Xt)                               # [9, C]
    sq_q = (Q * Q) @ sel                                   # [Q, 9]
    cos = _cosine(dots, sq_q.sqrt()[:, :, None], sq_x.sqrt()[None, :, :])

    gx, gq = Xt.index_select(0, gate_cols), Q.index_select(1, gate_cols)
    gate = (gq[:, :, None] > 0) & (gx[None, :, :] > 0)     # [Q, 13, C]
    sx, sq = Xt.index_select(0, scalar_cols), Q.index_select(1, scalar_cols)
    ssim = _scalar_sim(sq[:, :, None], sx[None, :, :])     # [Q, 5, C]

    feature_sims = _feature_sims(cos, gate, ssim, sq[:, :, None], sx[None, :, :], axis=1)
    feature_present = gate[:, :6, :]                       # [Q, 6, C]
    content_match = qc[:, None] == cc[None, :]             # [Q, C]
    overall, confidence, match_class, keep, _ = _overall(
        feature_sims, feature_present, w[:, :, None], content_match, content_filter, axis=1)
    out = {"overall": overall, "confidence": confidence, "match_class": match_class}
    if return_feature_sims:
        out["feature_sims"] = torch.where(keep[:, None, :], feature_sims, 0.0).transpose(1, 2)
        out["feature_present"] = (feature_present & keep[:, None, :]).transpose(1, 2)
    return out


def batched_similarity_detailed(
    query,                         # [D]
    corpus,                        # [C, D]
    weights,                       # [6]
    content_match,                 # [C] bool
    q_avail,                       # [6]
    c_avail,                       # [C, 6]
    q_dur,                         # [] seconds
    c_dur,                         # [C]
    q_series,                      # [2, T] centroid + rolloff
    c_series,                      # [C, 2, T]
    q_len,                         # [2] int32
    c_len,                         # [C, 2] int32
    num_mfcc_coeffs: int = 13,
    content_filter: bool = False,
    device: Device = DEFAULT_DEVICE,
) -> Dict[str, torch.Tensor]:
    """batched_similarity + the EnableDetailedMetrics quality chain
    (calculateQualityMetrics, comparison.go:892-1008) on the device, so
    mixed-content corpora (EnableDetailedMetrics defaults ON there,
    config.go:151) keep the one-pass path. Adds keys:
    data_availability, feature_coverage, temporal_alignment,
    noise_level, dynamic_range_match, spectral_coherence (all [C]);
    confidence includes the quality terms (comparison.go:1030-1033).

    Spectral coherence is the masked two-pass Pearson over the first
    min(len_q, len_c) frames of each series — float32 on the device
    against the host's float64 corrcoef agrees to
    utils/parity.COMPARATOR_COHERENCE_ATOL (centered accumulation), a
    reported diagnostic that feeds nothing downstream.
    """
    dev = _device_of(corpus, device)
    X = _tensor(corpus, dev, torch.float32)
    q = _tensor(query, dev, torch.float32)
    cm = _tensor(content_match, dev, torch.bool)
    base = batched_similarity(q, X, weights, cm, num_mfcc_coeffs=num_mfcc_coeffs,
                              content_filter=content_filter, device=dev)
    q_avail, c_avail = _tensor(q_avail, dev, torch.float32), _tensor(c_avail, dev, torch.float32)
    q_dur, c_dur = _tensor(q_dur, dev, torch.float32), _tensor(c_dur, dev, torch.float32)
    q_series, c_series = _tensor(q_series, dev, torch.float32), _tensor(c_series, dev, torch.float32)
    q_len, c_len = _tensor(q_len, dev, torch.int32), _tensor(c_len, dev, torch.int32)

    sims, present = base["feature_sims"], base["feature_present"]
    n_present = present.sum(dim=-1).to(torch.float32)               # [C]

    avail_n = (q_avail[None, :] * c_avail).sum(dim=-1)              # [C]
    data_availability = avail_n / 6.0
    feature_coverage = n_present / 6.0

    dur_diff = (q_dur - c_dur).abs()
    max_dur = torch.maximum(q_dur, c_dur)
    temporal_alignment = torch.where(
        max_dur > 0, 1.0 - torch.clamp_max(dur_diff / torch.clamp_min(max_dur, _EPS), 1.0), 1.0)

    # noise level = sqrt sample-variance of present-feature sims
    # (estimateNoiseLevel, comparison.go:938-963): none -> 0.5, one -> 0
    p = present.to(torch.float32)
    mean = (sims * p).sum(dim=-1) / torch.clamp_min(n_present, 1.0)
    var = ((sims - mean[:, None]) ** 2 * p).sum(dim=-1) / torch.clamp_min(n_present - 1.0, 1.0)
    noise_level = torch.where(
        n_present == 0, 0.5,
        torch.where(n_present <= 1, 0.0, torch.clamp_max(var.sqrt(), 1.0)))

    # dynamic range match (comparison.go:966-975)
    toff = _offsets(num_mfcc_coeffs)["temporal"]
    dr1, dr2 = q[toff], X[:, toff]
    t_avail = (q_avail[3] > 0) & (c_avail[:, 3] > 0)
    dynamic_range_match = torch.where(t_avail & (dr1 > 0) & (dr2 > 0), _scalar_sim(dr1, dr2), 0.5)

    # spectral coherence (comparison.go:977-1008): mean |Pearson| over
    # centroid + rolloff series truncated to the common length
    n = torch.minimum(q_len[None, :], c_len).to(torch.float32)     # [C, 2]
    t_axis = torch.arange(q_series.shape[-1], dtype=torch.float32, device=dev)
    mask = t_axis[None, None, :] < n[..., None]                    # [C, 2, T]
    qb = q_series[None, :, :] * mask
    cb = c_series * mask
    nn = torch.clamp_min(n, 1.0)
    mx = qb.sum(dim=-1) / nn                                       # [C, 2]
    my = cb.sum(dim=-1) / nn
    dx = (q_series[None, :, :] - mx[..., None]) * mask
    dy = (c_series - my[..., None]) * mask
    cov = (dx * dy).sum(dim=-1)
    vx = (dx * dx).sum(dim=-1)
    vy = (dy * dy).sum(dim=-1)
    # A series the host sees as exactly constant (float64 variance 0 ->
    # NaN corr -> skipped, comparison._quality_metrics) can pick up a
    # tiny float32 variance here from mean-subtraction rounding, turning
    # a skipped series into a garbage near-zero corr that halves the
    # mean (a pure tone's constant rolloff). Require a relative std of
    # > 1e-4 of the mean magnitude — genuine series sit orders of
    # magnitude above, float32 rounding noise (~1e-7 rel) orders below.
    tol_x = (1e-4 * (mx.abs() + 1.0)) ** 2 * nn
    tol_y = (1e-4 * (my.abs() + 1.0)) ** 2 * nn
    valid = (n > 1) & (vx > tol_x) & (vy > tol_y)
    corr = cov.abs() / torch.clamp_min((vx * vy).sqrt(), _EPS)
    n_valid = valid.sum(dim=-1).to(torch.float32)
    spectral_coherence = torch.where(
        n_valid > 0,
        torch.where(valid, corr, 0.0).sum(dim=-1) / torch.clamp_min(n_valid, 1.0),
        0.5,
    )

    # confidence WITH quality terms (comparison.go:1011-1037): the
    # availability/noise adjustments land before the [0, 1] clip
    keep = cm if content_filter else torch.ones_like(cm)
    conf = (_base_confidence(base["overall"], cm, n_present)
            + data_availability * 0.1 - noise_level * 0.1)
    base["confidence"] = torch.where(keep, torch.clamp(conf, 0.0, 1.0), 0.0)
    base.update(
        data_availability=data_availability,
        feature_coverage=feature_coverage,
        temporal_alignment=temporal_alignment,
        noise_level=noise_level,
        dynamic_range_match=dynamic_range_match,
        spectral_coherence=spectral_coherence,
    )
    return base


def sharded_batched_similarity(
    query_vec,
    corpus,
    weights,
    content_match,
    mesh=None,
    num_mfcc_coeffs: int = 13,
    content_filter: bool = False,
    quality: Optional[Tuple] = None,
    device: Device = DEFAULT_DEVICE,
) -> Dict[str, np.ndarray]:
    """batched_similarity (or, with `quality` = (q_avail, q_dur,
    q_series, q_len, c_avail, c_dur, c_series, c_len), the detailed
    pass), the result fetched to the host as one dict of numpy [C].

    Without a mesh it runs on one device (the corpus's, or `device` for
    numpy) with one wait. With a mesh the corpus rows, `content_match`
    and the corpus's quality arrays are split as JAX pads and shards them
    over the "data" axis (`parallel/mesh.row_shards`), the query
    replicated: every shard is launched on its device before any result
    is read, and under a process group the ranks' rows are all-gathered.
    """
    from sonido_sonar_tpu_torch.parallel.mesh import gather_processes, on_device, row_shards

    c = corpus.shape[0]
    shards = [(_device_of(corpus, device), 0, c)] if mesh is None else row_shards(c, mesh)
    parts = []
    for dev, lo, hi in shards:
        rows = slice(lo, hi)
        with on_device(dev):
            X = _tensor(corpus[rows], dev)
            cm = _tensor(content_match[rows], dev)
            if quality is None:
                out = batched_similarity(query_vec, X, weights, cm, num_mfcc_coeffs=num_mfcc_coeffs,
                                         content_filter=content_filter, device=dev)
            else:
                q_avail, q_dur, q_series, q_len, c_avail, c_dur, c_series, c_len = quality
                out = batched_similarity_detailed(
                    query_vec, X, weights, cm, q_avail, c_avail[rows], np.float32(q_dur),
                    c_dur[rows], q_series, c_series[rows], q_len, c_len[rows],
                    num_mfcc_coeffs=num_mfcc_coeffs, content_filter=content_filter, device=dev)
            parts.append((dev, _copy_to_host_async(out)))
    host = []
    for dev, (part, event) in parts:
        if event is not None:
            event.synchronize()
        host.append({k: v.numpy() for k, v in part.items()})
    if mesh is not None:
        host = [h for rank in gather_processes(host, mesh) for h in rank]
    if len(host) == 1:
        return host[0]
    return {k: np.concatenate([h[k] for h in host]) for k in host[0]}
