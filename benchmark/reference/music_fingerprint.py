"""Plain reference of upstream's `GenerateFingerprint` (RyanBlaney/
sonido-sonar fingerprint/fingerprint.go:137-236) at its
`DefaultFingerprintConfig` (window 2048, hop 512, fingerprint.go:70-98)
on a tagged music library: each clip's metadata says `music`, which
`GenerateFingerprint` takes before any acoustic detection
(fingerprint.go:149-170); the MUSIC row of the content table
(content_config.go:106-278) sets MFCC, chroma, contrast and the harmonic
set on; the clip gets `MusicFeatureExtractor` (extractors/music.go:
22-243), which upstream's factory leaves commented out (quirk #1) and
the port wires under `strict_reference_routing=False`. The payload is
`music.go:178-243`'s in the port's `ExtractedFeatures` names.

Plain PyTorch, float32, TF32 off, none of the program's code. It takes
the DFT-matmul magnitudes, the mel, DCT, lifter and chroma tables, the
descriptors and the sorted-band contrast of `fingerprint_features.py`,
and the loudness range of `content_fingerprint.py`; the rest is written
out here from upstream's description:

- DC removal (R = 0.995) then pre-emphasis at 0.95 (music.go:245-259);
  the magnitudes (Hann, 2048/512) of the raw signal, every time-domain
  feature of the preprocessed one.
- Onsets (music.go:406-416): the interior local maxima of the spectral
  flux at or above 0.3 of its largest value, thinned to 50 ms (4
  frames) by a greedy scan per row (a candidate is kept when it lies 4
  or more frames after the last kept one); density over the clip's
  seconds; attack 0.01 s at each onset (music.go:418-424).
- Tempo (tempo_estimation.go:22-119): flux onsets of 1024/512
  magnitudes, normalized to a largest value of 1, threshold 0.3, and
  energy onsets of the 512/256 RMS's rises, normalized, threshold 0.1,
  each thinned to 50 ms and cut to its first 256 positions (frame x
  hop); the two lists merged in order, an onset dropped within 2,205
  samples (50 ms) of the last kept one; the intervals between kept
  onsets vote for the nearest of 14 tempo bins (60-180 by 10, 200)
  within 10 BPM when in (0.2 s, 2 s); the most voted bin, the lowest on
  a tie; 120 when none votes, 0 with fewer than two onsets.
- Dynamic range: 20 log10 of the 95th over the 10th percentile (sorted
  index) of the 1024/512 RMS, the low one floored at 1e-10
  (dynamic_range.go:27-28); crest the per-frame peak over RMS; silence
  the share of 2048/512 frames under -40 dBFS; the envelope the RMS of
  frames of N // T samples at hop 512 (music.go:383-386).
- Energy (music.go:478-525): the speech extractor's step, entropy
  elementwise -E ln(E + 1e-10), the loudness range p95 - p10 of 400 ms
  windows (25 % hop).
- Harmonic (music.go:528-592): T contiguous frames of N // T samples;
  YIN (80-1000 Hz, threshold 0.15) with the difference function as a
  direct sum over the frame's first half, d(tau) = sum_j (x[j] -
  x[j + tau])^2, in float64; HNR 10 log10(r / (1 - r)) of the
  normalized autocorrelation of the mean-removed frame at the period's
  lag int(sr / f0), as a direct sum in float64; inharmonicity 1 -
  voicing where the pitch is confident (over 0.5); the tonal centroid
  the spectral centroid times voicing.
- Key and chords (chroma_stft.go:240-330, chord_detection.go:16-247):
  the Pearson correlations of the mean chroma with the 24 rotated
  major and minor profiles, and per frame the cosine of the chroma with
  the 108 unit templates (9 qualities x 12 roots), its best index and
  score. `ExtractedFeatures` (features.go:5-27) has no field for them,
  so the fingerprint does not carry them and the cell cannot compare
  them; `tonal_numbers` holds the program's music extractor output to
  them in the tests.

Departures from upstream, each the port's documented semantics (which
this reference holds the port to): the float32 tensor math (upstream:
float64); the DC blocker computed as its impulse response (R^k,
truncated at 8,192 taps, where R^k < 2e-18) convolved by a float64 FFT,
where upstream runs the recursion sample by sample; the fixed 0.01 s
attack; dynamic range and the loudness range by sorted index.

`compare` reads one number per group of keys (`NUMBERS`). The harmonic
set is read in two: the share of frames whose decisions differ (voiced
or not, the pitch beyond 1e-3 of itself, HNR's lag, confidence over
0.5) and the largest gap of its six series over the frames where every
decision agrees, HNR as the autocorrelation it is computed from.

`lowp=True` is the control: the reference one precision below the
configuration's float32, as TF32 takes its inputs. Every matmul runs in
TF32 (on the card), and two sums that the program computes as float32
matmuls are computed here the same way with their inputs rounded to
TF32's 10-bit mantissa (`tf32`, on any device): the DC blocker's
convolution (the program's block scan) and the YIN difference, whose
cross term becomes DFT matmuls of the frame (the program's form) in
place of the direct float64 sum.
"""

from __future__ import annotations

import functools
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import content_fingerprint as CF
from benchmark.reference import fingerprint_features as FF

EPS = 1e-10
ROWS = 16                       # clips a block; the reference's peak stays a few GB
YIN_CHUNK_BYTES = 256 << 20     # one float64 temporary of the direct YIN sums
DC_TAPS = 8192
DECISION_RTOL = 1e-3
QUANTILE = 0.999
TEMPO_BINS = (60.0, 70.0, 80.0, 90.0, 100.0, 110.0, 120.0, 130.0, 140.0, 150.0, 160.0, 170.0, 180.0,
              200.0)
_FAR = 1 << 30
PICK_RTOL = 1e-3                # a pitch that moves by more than this share of itself moved its pick

# chroma_stft.go's key profiles, roots C..B
MAJOR = (1.0, 0.2, 0.6, 0.2, 0.8, 0.6, 0.2, 1.0, 0.2, 0.6, 0.2, 0.4)
MINOR = (1.0, 0.2, 0.4, 0.6, 0.2, 0.8, 0.2, 0.6, 0.8, 0.2, 0.4, 0.2)
# chord_detection.go's qualities, in its order
QUALITIES = ((0, 4, 7), (0, 3, 7), (0, 3, 6), (0, 4, 8), (0, 2, 7), (0, 5, 7), (0, 4, 7, 11),
             (0, 3, 7, 10), (0, 4, 7, 10))


@functools.lru_cache(maxsize=1)
def key_profiles() -> np.ndarray:
    """[24, 12]: the major profile rolled to roots 0..11, then the minor."""
    return np.stack([np.roll(MAJOR, r) for r in range(12)] + [np.roll(MINOR, r) for r in range(12)]
                    ).astype(np.float32)


@functools.lru_cache(maxsize=1)
def chord_templates() -> np.ndarray:
    """[108, 12] unit templates, quality-major then root."""
    rows = []
    for q in QUALITIES:
        base = np.zeros(12)
        base[list(q)] = 1.0
        base /= np.linalg.norm(base)
        rows += [np.roll(base, r) for r in range(12)]
    return np.stack(rows).astype(np.float32)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 `t` rounded to TF32's 10-bit mantissa (to nearest, ties
    away from zero), as a TF32 matmul takes its inputs."""
    i = t.to(torch.float32).contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


# -- preprocessing and framing ------------------------------------------------

def dc_removal(x: torch.Tensor, pole: float = 0.995, lowp: bool = False) -> torch.Tensor:
    """y[n] = x[n] - x[n-1] + R y[n-1] as the differences convolved with
    R^k (k < DC_TAPS) by a float64 FFT; `lowp` rounds both to TF32
    first."""
    u = x.to(torch.float64)
    u = u - F.pad(u[..., :-1], (1, 0))
    n = u.shape[-1]
    m = 1 << (n + DC_TAPS).bit_length()
    h = pole ** torch.arange(DC_TAPS, dtype=torch.float64, device=x.device)
    if lowp:
        u, h = tf32(u).to(torch.float64), tf32(h).to(torch.float64)
    y = torch.fft.irfft(torch.fft.rfft(u, m) * torch.fft.rfft(h, m), m)[..., :n]
    return y.to(torch.float32)


def frames_of(x: torch.Tensor, w: int, hop: int) -> torch.Tensor:
    return x.unfold(-1, w, hop)


def rms(x: torch.Tensor, w: int, hop: int) -> torch.Tensor:
    f = frames_of(x, w, hop)
    return torch.sqrt(torch.mean(f * f, dim=-1))


def zcr(pre: torch.Tensor, w: int, hop: int, sr: int) -> torch.Tensor:
    """Sign changes (x >= 0 against x < 0) between a frame's neighbouring
    samples, per second of frame."""
    nonneg = frames_of(pre, w, hop) >= 0
    crossings = torch.sum(nonneg[..., 1:] != nonneg[..., :-1], dim=-1).to(torch.float32)
    return crossings * float(np.float32(1.0) / np.float32(w / float(sr)))


# -- onsets and tempo ---------------------------------------------------------

def peaks_at_or_above(v: torch.Tensor, thr) -> torch.Tensor:
    """Interior local maxima of v [R, T] at or above thr, False at both ends."""
    inner = (v[..., 1:-1] > v[..., :-2]) & (v[..., 1:-1] > v[..., 2:]) & (v[..., 1:-1] >= thr)
    return F.pad(inner, (1, 1))


def thin(cand: torch.Tensor, min_frames: int) -> torch.Tensor:
    """The greedy scan per row: a candidate is kept when it lies
    `min_frames` or more frames after the last kept one."""
    c = cand.cpu().numpy()
    out = np.zeros_like(c)
    for r in range(c.shape[0]):
        last = -min_frames - 1
        for i in np.flatnonzero(c[r]).tolist():
            if i - last >= min_frames:
                out[r, i] = True
                last = i
    return torch.from_numpy(out).to(cand.device)


def flux(m: torch.Tensor) -> torch.Tensor:
    d = m[..., 1:, :] - m[..., :-1, :]
    return F.pad(torch.sqrt(torch.sum(torch.where(d > 0, d * d, 0.0), dim=-1)), (1, 0))


def unit_max(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(torch.amax(v, dim=-1, keepdim=True), 1e-10)


def positions(mask: torch.Tensor, hop: int, limit: int) -> List[List[int]]:
    return [(np.flatnonzero(row)[:limit] * hop).tolist() for row in mask.cpu().numpy()]


def tempo_of(pos: List[int], sr: int, device) -> float:
    """findTempoFromIntervals over the kept onsets' consecutive intervals."""
    if len(pos) < 2:
        return 0.0
    iv = torch.tensor(np.diff(np.asarray(pos, dtype=np.int64)).astype(np.int32), device=device
                      ).to(torch.float32) / float(sr)
    bins = torch.tensor(TEMPO_BINS, dtype=torch.float32, device=device)
    tempo = 60.0 / torch.clamp_min(iv, 1e-6)
    diffs = torch.abs(tempo[:, None] - bins)
    votes = [0] * len(TEMPO_BINS)
    for ok, d, k in zip(((iv > 0.2) & (iv < 2.0)).tolist(), torch.amin(diffs, dim=-1).tolist(),
                        torch.argmin(diffs, dim=-1).tolist()):
        if ok and d < 10.0:
            votes[k] += 1
    if max(votes) == 0:
        return 120.0
    return TEMPO_BINS[votes.index(max(votes))]


def tempo(pre: torch.Tensor, cfg: dict) -> torch.Tensor:
    sr = int(cfg["sample_rate"])
    min_s, limit = float(cfg["onset_min_interval_s"]), int(cfg["max_onsets"])
    fw, fh = int(cfg["tempo_flux_window"]), int(cfg["tempo_flux_hop"])
    ew, eh = int(cfg["tempo_energy_window"]), int(cfg["tempo_energy_hop"])
    f = unit_max(flux(FF.magnitudes(pre, fw, fh)))
    p1 = positions(thin(peaks_at_or_above(f, float(cfg["tempo_flux_threshold"])), max(int(min_s * sr / fh), 1)),
                   fh, limit)
    env = rms(pre, ew, eh)
    rise = unit_max(F.pad(torch.clamp_min(env[..., 1:] - env[..., :-1], 0.0), (1, 0)))
    p2 = positions(thin(peaks_at_or_above(rise, float(cfg["tempo_energy_threshold"])),
                        max(int(min_s * sr / eh), 1)), eh, limit)
    tol = int(min_s * sr)
    out = []
    for a, b in zip(p1, p2):
        kept, last = [], -_FAR
        for p in sorted(a + b):
            if p - last > tol:
                kept.append(p)
                last = p
        out.append(tempo_of(kept, sr, pre.device))
    return torch.tensor(out, dtype=torch.float32, device=pre.device)


# -- the harmonic set ---------------------------------------------------------

def yin_difference(frames: torch.Tensor) -> torch.Tensor:
    """d(tau) = sum_{j < W/2} (x[j] - x[j + tau])^2, tau < W/2, as a
    direct float64 sum, [..., W] -> [..., W/2] float32."""
    w = frames.shape[-1]
    h = w // 2
    flat = frames.reshape(-1, w).to(torch.float64)
    d = torch.empty((flat.shape[0], h), dtype=torch.float64, device=frames.device)
    step = max(YIN_CHUNK_BYTES // (8 * h * h), 1)
    for lo in range(0, flat.shape[0], step):
        f = flat[lo: lo + step]
        diff = f[:, None, :h] - f.unfold(-1, h, 1)[:, :h, :]
        d[lo: lo + step] = torch.sum(diff * diff, dim=-1)
    return d.to(torch.float32).reshape(frames.shape[:-1] + (h,))


@functools.lru_cache(maxsize=2)
def _dft_tables(w: int):
    """float64 [W, 2F] forward (cos | sin) and [2F, W/2] inverse tables of
    a real DFT of size W, F = W/2 + 1 bins."""
    n = np.arange(w)[:, None]
    k = np.arange(w // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / w
    fwd = np.concatenate([np.cos(ang), np.sin(ang)], axis=1)
    c = np.full(w // 2 + 1, 2.0)
    c[0] = c[-1] = 1.0
    t = np.arange(w // 2)[None, :]
    back = 2.0 * np.pi * np.arange(w // 2 + 1)[:, None] * t / w
    inv = np.concatenate([c[:, None] * np.cos(back), -c[:, None] * np.sin(back)], axis=0) / w
    return fwd, inv


def yin_difference_dft(frames: torch.Tensor, lowp: bool = False) -> torch.Tensor:
    """The YIN difference as the program computes it: the two energies
    (float64 prefix sums) less twice the cross term r(tau) = sum_{j < W/2}
    x[j] x[j + tau], which is the inverse real DFT of conj(DFT(first
    half, zero-padded)) DFT(frame), three float32 matmuls of [..., W]
    frames; `lowp` rounds every matmul's inputs to TF32."""
    w = frames.shape[-1]
    h, nb = w // 2, w // 2 + 1
    fwd, inv = (torch.as_tensor(t, dtype=torch.float32, device=frames.device) for t in _dft_tables(w))
    rnd = tf32 if lowp else (lambda t: t)
    x = frames.reshape(-1, w).to(torch.float32)
    first = F.pad(x[:, :h], (0, w - h))
    d = torch.empty((x.shape[0], h), dtype=torch.float32, device=frames.device)
    step = max(YIN_CHUNK_BYTES // (8 * w), 1)
    for lo in range(0, x.shape[0], step):
        xs, fs = x[lo: lo + step], first[lo: lo + step]
        sx, sf = torch.matmul(rnd(xs), rnd(fwd)), torch.matmul(rnd(fs), rnd(fwd))
        xc, xsn, fc, fsn = sx[:, :nb], sx[:, nb:], sf[:, :nb], sf[:, nb:]
        cross = torch.cat([fc * xc + fsn * xsn, fsn * xc - fc * xsn], dim=-1)
        r = torch.matmul(rnd(cross), rnd(inv)).to(torch.float64)
        c = F.pad(torch.cumsum(xs.to(torch.float64) ** 2, dim=-1), (1, 0))
        d[lo: lo + step] = (c[:, h: h + 1] + (c[:, h: 2 * h] - c[:, :h]) - 2.0 * r).to(torch.float32)
    return d.reshape(frames.shape[:-1] + (h,))


def yin_pick(d: torch.Tensor, sr: int, fmin: float = 80.0, fmax: float = 1000.0,
             threshold: float = 0.15):
    """CMNDF, the first dip under the threshold below its right
    neighbour, its parabola, the range check: (pitch, confidence)."""
    h = d.shape[-1]
    tau = torch.arange(1, h, dtype=torch.float32, device=d.device)
    cm = torch.cat([torch.ones_like(d[..., :1]),
                    d[..., 1:] * tau / torch.clamp_min(torch.cumsum(d[..., 1:], dim=-1), EPS)], dim=-1)
    nxt = torch.cat([cm[..., 1:], torch.full_like(cm[..., :1], float("inf"))], dim=-1)
    cand = (cm < threshold) & (cm < nxt)
    cand[..., 0] = False
    has = torch.any(cand, dim=-1)
    t0 = torch.argmax(cand.to(torch.uint8), dim=-1)

    def at(i):
        return torch.gather(cm, -1, i[..., None])[..., 0]

    y0, y1, y2 = at(torch.clamp(t0 - 1, 0, h - 1)), at(t0), at(torch.clamp(t0 + 1, 0, h - 1))
    den = y0 - 2.0 * y1 + y2
    ok = torch.abs(den) > EPS
    shift = torch.where(ok, 0.5 * (y0 - y2) / torch.where(ok, den, 1.0), 0.0)
    period = t0.to(torch.float32) + torch.where((t0 > 0) & (t0 < h - 1), shift, 0.0)
    freq = sr / torch.clamp_min(period, EPS)
    good = has & (freq >= fmin) & (freq <= fmax)
    return torch.where(good, freq, 0.0), torch.where(good, 1.0 - y1, 0.0)


def hnr(frames: torch.Tensor, sr: int, pitch: torch.Tensor) -> torch.Tensor:
    """10 log10(r / (1 - r)), r the normalized autocorrelation of the
    mean-removed frame at lag int(sr / max(f0, 1)), direct float64 sums."""
    x = frames.to(torch.float32)
    x = (x - torch.mean(x, dim=-1, keepdim=True)).to(torch.float64)
    n = x.shape[-1]
    lag = torch.full_like(pitch, float(sr)) / torch.clamp_min(pitch, 1.0)
    lag = torch.clamp(lag.to(torch.int64), 1, n - 1)[..., None]
    j = torch.arange(n, device=x.device)
    shifted = torch.gather(x, -1, torch.clamp(j + lag, max=n - 1).expand(x.shape))
    r = torch.sum(torch.where(j < n - lag, x * shifted, 0.0), dim=-1)
    r0 = torch.clamp_min(torch.sum(x * x, dim=-1), EPS)
    r_t = torch.clamp((r / r0).to(torch.float32), EPS, 1.0 - 1e-6)
    return 10.0 * torch.log10(r_t / (1.0 - r_t))


# -- the payload ---------------------------------------------------------------

def payload_block(pcm: torch.Tensor, cfg: dict, lowp: bool = False) -> Dict[str, torch.Tensor]:
    """The music extractor's output for [R, N] clips, in the names of the
    port's `batched_music_extractor_features`; `lowp` the control's
    (module docstring)."""
    sr, w, hop = int(cfg["sample_rate"]), int(cfg["window_size"]), int(cfg["hop_size"])
    dev = pcm.device
    x = pcm.to(torch.float32)
    n = x.shape[-1]
    pre = FF.pre_emphasis(dc_removal(x, float(cfg["dc_pole"]), lowp), float(cfg["pre_emphasis"]))
    m = FF.magnitudes(x, w, hop)
    power = m * m
    nb, t = m.shape[-1], m.shape[-2]
    out = FF.descriptors(m, sr)
    p_sum = torch.sum(power, dim=-1)
    reached = torch.cumsum(power, dim=-1) >= FF.ROLLOFF * p_sum[..., None]
    first = torch.where(torch.any(reached, dim=-1), torch.argmax(reached.to(torch.uint8), dim=-1), nb - 1)
    out["spectral_rolloff"] = torch.where(p_sum > 0, first.to(torch.float32), 0.0) * ((sr / 2.0) / float(nb - 1))
    out["spectral_contrast"] = FF.contrast(m, sr, int(cfg["contrast_bands"]))
    out["zcr"] = zcr(pre, w, hop, sr)[..., :t]
    dct, lift = FF.dct_lifter(int(cfg["mfcc_coefficients"]), int(cfg["mel_filters"]), float(cfg["lifter"]))
    mel = torch.matmul(power, FF._t(FF.mel_bank(int(cfg["mel_filters"]), w, sr), dev).T)
    out["mfcc"] = torch.matmul(torch.log(torch.clamp_min(mel, FF.LOG_FLOOR)), FF._t(dct, dev).T) * FF._t(lift, dev)

    energy = torch.matmul(power, FF._t(FF.chroma_fold(nb, sr, w), dev).T)
    tot = torch.sum(energy, dim=-1, keepdim=True)
    chroma = torch.where(tot > EPS, energy / torch.clamp_min(tot, EPS), energy)
    out["chroma"] = chroma
    mean = torch.mean(chroma, dim=-2)[..., None, :]
    prof = FF._t(key_profiles(), dev)
    xm, pm = mean - torch.mean(mean, dim=-1, keepdim=True), prof - torch.mean(prof, dim=-1, keepdim=True)
    den = torch.sqrt(torch.sum(xm * xm, dim=-1) * torch.sum(pm * pm, dim=-1))
    out["key_correlations"] = torch.where(den < EPS, 0.0, torch.sum(xm * pm, dim=-1) / torch.clamp_min(den, EPS))
    unit = chroma / torch.clamp_min(torch.linalg.vector_norm(chroma, dim=-1, keepdim=True), EPS)
    sims = torch.matmul(unit, FF._t(chord_templates(), dev).T)
    out["chord_index"] = torch.argmax(sims, dim=-1).to(torch.int32)
    out["chord_score"] = torch.amax(sims, dim=-1)

    ste = rms(pre, w, hop)
    out["rms_energy"] = ste
    min_frames = max(int(float(cfg["onset_min_interval_s"]) * sr / hop), 1)
    cand = peaks_at_or_above(out["spectral_flux"], float(cfg["onset_threshold"])
                             * torch.amax(out["spectral_flux"], dim=-1, keepdim=True))
    mask = thin(cand, min_frames)
    out["onset_mask"] = mask
    out["onset_density"] = torch.sum(mask, dim=-1).to(torch.float32) / (n / float(sr))
    out["attack_time"] = torch.where(mask, 0.01, 0.0)
    out["peak_amplitude"] = torch.amax(torch.abs(pre), dim=-1)
    out["average_amplitude"] = torch.mean(torch.abs(pre), dim=-1)
    drms = rms(pre, int(cfg["dynamic_range_window"]), int(cfg["dynamic_range_hop"]))
    s = torch.sort(drms, dim=-1).values
    td = s.shape[-1]
    lo_v, hi_v = torch.clamp_min(s[..., int(0.10 * (td - 1))], EPS), s[..., int(0.95 * (td - 1))]
    out["dynamic_range"] = torch.where(hi_v > 0, 20.0 * torch.log10(hi_v / lo_v), 0.0)
    fr = frames_of(pre, w, hop)
    peak = torch.amax(torch.abs(fr), dim=-1)
    out["crest_factor"] = torch.where(ste > 0, peak / torch.clamp_min(ste, EPS), 0.0)
    silent = 20.0 * torch.log10(torch.clamp_min(ste, EPS)) < float(cfg["silence_db"])
    out["silence_ratio"] = torch.mean(silent.to(torch.float32), dim=-1)
    out["envelope_shape"] = rms(pre, max(n // t, 1), hop)
    out["tempo_bpm"] = tempo(pre, cfg)

    mean_e = torch.mean(ste, dim=-1, keepdim=True)
    out["energy_variance"] = torch.sum((ste - mean_e) ** 2, dim=-1) / (t - 1)
    out["energy_entropy"] = torch.where(ste > 0, -ste * torch.log(ste + 1e-10), 0.0)
    out["loudness_range"] = CF.loudness_range(pre, sr)
    den_p = torch.clamp_min(p_sum, EPS)
    out["low_energy_ratio"] = torch.where(p_sum > 0, torch.sum(power[..., : nb // 4], dim=-1) / den_p, 0.0)
    out["high_energy_ratio"] = torch.where(p_sum > 0, torch.sum(power[..., nb // 4:], dim=-1) / den_p, 0.0)

    size = n // t
    frames = pre[..., : t * size].reshape(pre.shape[:-1] + (t, size))
    pitch, conf = yin_pick(yin_difference_dft(frames, True) if lowp else yin_difference(frames), sr)
    out["pitch"], out["pitch_confidence"], out["voicing"] = pitch, conf, conf
    out["hnr"] = torch.where(pitch > 0, hnr(frames, sr, pitch), 0.0)
    out["inharmonicity"] = torch.where((pitch > 0) & (conf > 0.5), 1.0 - torch.clamp(conf, 0.0, 1.0), 0.0)
    out["tonal_centroid"] = out["spectral_centroid"][..., :t] * conf
    return out


SP, EN, TP, HP = "spectral_features.", "energy_features.", "temporal_features.", "harmonic_features."
# the fingerprint's field path of each output the payload carries, by
# the content table's flag that puts it there (None: always)
PATHS = {
    "mfcc": ("mfcc", "mfcc"),
    "chroma": ("chroma_features", "chroma"),
    **{k: (SP + k, None) for k in ("spectral_centroid", "spectral_rolloff", "spectral_bandwidth",
                                   "spectral_flatness", "spectral_crest", "spectral_slope",
                                   "spectral_flux", "spectral_contrast")},
    "zcr": (SP + "zero_crossing_rate", None),
    **{k: (TP + k, None) for k in ("rms_energy", "peak_amplitude", "average_amplitude", "dynamic_range",
                                   "crest_factor", "silence_ratio", "onset_density", "onset_mask",
                                   "attack_time", "envelope_shape", "tempo_bpm")},
    "energy.rms_energy": (EN + "short_time_energy", None),
    **{k: (EN + k, None) for k in ("energy_variance", "energy_entropy", "loudness_range",
                                   "low_energy_ratio", "high_energy_ratio")},
    "pitch": (HP + "pitch_estimate", "harmonic"),
    "pitch_confidence": (HP + "pitch_confidence", "harmonic"),
    "voicing": (HP + "voicing_strength", "harmonic"),
    "hnr": (HP + "harmonic_ratio", "harmonic"),
    "inharmonicity": (HP + "inharmonicity_ratio", "harmonic"),
    "tonal_centroid": (HP + "tonal_centroid", "harmonic"),
}
TONAL_KEYS = ("key_correlations", "chord_index", "chord_score")


def music_features(pcm: torch.Tensor, cfg: dict, lowp: bool = False) -> Dict[str, torch.Tensor]:
    """[B, N] clips -> the music extractor's outputs, [B]-leading, in
    blocks of ROWS clips."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(lowp)
    try:
        parts = [payload_block(pcm[lo: lo + ROWS], cfg, lowp) for lo in range(0, pcm.shape[0], ROWS)]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def fingerprints(pcm: torch.Tensor, cfg: dict, lowp: bool = False) -> dict:
    """[B, N] tagged clips -> {"types": [B] str, "subtypes": [B] None,
    "rows": [B] dicts of each clip's payload by field path,
    "sample_rate": the configuration's}."""
    out = music_features(pcm, cfg, lowp)
    on = CF.flags("music")
    rows: List[dict] = [{} for _ in range(pcm.shape[0])]
    for key, (path, flag) in PATHS.items():
        if flag is None or on[flag]:
            v = out[key.split(".")[-1]]
            for i, row in enumerate(rows):
                row[path] = v[i]
    return {"types": ["music"] * len(rows), "subtypes": [None] * len(rows), "rows": rows,
            "sample_rate": int(cfg["sample_rate"])}


# -- the comparison -----------------------------------------------------------

# number -> (how it reads, the field paths it reads), over every clip.
# "gap": the largest |difference| over the key's largest |reference
# value|, the worst key; "quantile": the 99.9th percentile of that ratio
# (keys that take the log of every bin, as in the backfill); "flips": the
# share of frames that differ by more than DECISION_RTOL of the key's
# largest value, the worst key (per-frame decisions: a sign-change count,
# the first bin past 85 % of the power); "share": the same share over
# every entry of the group's keys together (the onsets: each frame's mark
# and attack and each clip's count, so that one onset more or less is one
# event among the group's entries; each clip's tempo bin; per-clip values
# that count decisions: silent frames, the frames at two percentiles);
# "picks": the share of frames
# whose harmonic decisions differ (`same_picks`); "picked_gap": "gap" over
# the frames where they agree, HNR as the autocorrelation r it is
# computed from (`AS_COMPARED`: its dB's slope grows without bound as r
# nears 0, where a voiced frame's r may sit).
HARMONIC = (HP + "pitch_estimate", HP + "pitch_confidence", HP + "voicing_strength", HP + "harmonic_ratio",
            HP + "inharmonicity_ratio", HP + "tonal_centroid")
AS_COMPARED = {HP + "harmonic_ratio": lambda db: 1.0 / (1.0 + 10.0 ** (-db / 10.0))}
NUMBERS = {
    "mfcc_gap": ("gap", ("mfcc",)),
    "chroma_gap": ("gap", ("chroma_features",)),
    "spectral_centroid_gap": ("gap", (SP + "spectral_centroid",)),
    "spectral_bandwidth_gap": ("gap", (SP + "spectral_bandwidth",)),
    "spectral_crest_gap": ("gap", (SP + "spectral_crest",)),
    "spectral_flux_gap": ("gap", (SP + "spectral_flux",)),
    "spectral_contrast_gap": ("gap", (SP + "spectral_contrast",)),
    "spectral_flatness_q999_gap": ("quantile", (SP + "spectral_flatness",)),
    "spectral_slope_q999_gap": ("quantile", (SP + "spectral_slope",)),
    "energy_gap": ("gap", (EN + "short_time_energy", EN + "energy_variance", EN + "energy_entropy",
                           EN + "low_energy_ratio", EN + "high_energy_ratio", TP + "rms_energy")),
    "temporal_gap": ("gap", (TP + "peak_amplitude", TP + "average_amplitude", TP + "crest_factor",
                             TP + "envelope_shape", EN + "loudness_range")),
    "zcr_flips": ("flips", (SP + "zero_crossing_rate",)),
    "rolloff_flips": ("flips", (SP + "spectral_rolloff",)),
    "harmonic_flips": ("picks", HARMONIC),
    "harmonic_gap": ("picked_gap", HARMONIC),
    "onset_flips": ("share", (TP + "onset_mask", TP + "attack_time", TP + "onset_density")),
    "clip_decision_flips": ("share", (TP + "silence_ratio", TP + "dynamic_range")),
    "tempo_flips": ("share", (TP + "tempo_bpm",)),
}
# the music extractor's outputs the fingerprint does not carry, for the tests
TONAL_NUMBERS = {
    "key_gap": ("gap", ("key_correlations", "chord_score")),
    "chord_flips": ("flips", ("chord_index",)),
}


def _structure_ok(got: dict, want: dict) -> bool:
    if len(got.get("types", [])) != len(want["types"]) or len(got.get("rows", [])) != len(want["rows"]):
        return False
    for g, w in zip(got["rows"], want["rows"]):
        if set(g) != set(w):
            return False
        for k, v in w.items():
            a = torch.as_tensor(g[k])
            if tuple(a.shape) != tuple(v.shape) or (a.is_floating_point() and not bool(torch.isfinite(a).all())):
                return False
    return True


def same_picks(pair, sr: int) -> torch.Tensor:
    """Frames whose harmonic decisions agree: both voiced or both not,
    and where voiced the pitch within PICK_RTOL of the reference's, the
    same HNR lag int(sr / f0) (in float32, as both sides compute it) and
    the same side of 0.5 in confidence (inharmonicity's gate)."""
    (gp, rp), (gc, rc) = pair(HP + "pitch_estimate"), pair(HP + "pitch_confidence")

    def lag(p):
        p = p.to(torch.float32)
        return (torch.full_like(p, float(sr)) / torch.clamp_min(p, 1.0)).to(torch.int64)

    voiced = rp > 0
    same = ((torch.abs(gp - rp) <= PICK_RTOL * rp) & (lag(gp) == lag(rp)) & ((gc > 0.5) == (rc > 0.5)))
    return ((gp > 0) == voiced) & (~voiced | same)


def read_numbers(numbers: dict, pair, sr: int = 0) -> Dict[str, float]:
    """Each number of `numbers` from pair(key) -> (program, reference)
    float64 tensors; `sr` for the harmonic picks."""
    out = {}
    agree = None
    for name, (how, keys) in numbers.items():
        if how in ("picks", "picked_gap") and agree is None:
            agree = same_picks(pair, sr)
        if how == "picks":
            out[name] = float(torch.mean((~agree).to(torch.float64)))
            continue
        worst, differ, total = 0.0, 0, 0
        for key in keys:
            g, r = pair(key)
            if how == "picked_gap" and key in AS_COMPARED:
                g, r = AS_COMPARED[key](g), AS_COMPARED[key](r)
            scale = max(float(torch.amax(torch.abs(r))), 1e-30)
            if how == "gap":
                worst = max(worst, float(torch.amax(torch.abs(g - r))) / scale)
            elif how == "picked_gap":
                worst = max(worst, float(torch.amax(torch.where(agree, torch.abs(g - r), 0.0))) / scale)
            elif how == "quantile":
                rel = (torch.abs(g - r) / scale).flatten().float()
                worst = max(worst, float(torch.quantile(rel, QUANTILE)))
            elif how == "flips":
                worst = max(worst, float(torch.mean((torch.abs(g - r) > DECISION_RTOL * scale)
                                                    .to(torch.float64))))
            else:   # share of every entry of the group's keys that differs
                differ += int(torch.sum(torch.abs(g - r) > DECISION_RTOL * scale))
                total += r.numel()
        out[name] = differ / total if how == "share" and total else worst
    return out


def _numbers(got: dict, want: dict) -> Dict[str, float]:
    if not _structure_ok(got, want):
        return {name: float("inf") for name in ("content_type_mismatches",) + tuple(NUMBERS)}
    b = len(want["types"])
    mismatched = sum((g, gs) != (w, ws) for g, gs, w, ws in zip(got["types"], got["subtypes"],
                                                                 want["types"], want["subtypes"]))

    def pair(key):
        r = torch.stack([row[key] for row in want["rows"]]).to(torch.float64)
        g = torch.stack([torch.as_tensor(row[key]) for row in got["rows"]]).to(r.device, torch.float64)
        return g, r

    return {"content_type_mismatches": mismatched / b, **read_numbers(NUMBERS, pair, int(want["sample_rate"]))}


def compare(program: List[dict], expected: List[dict]) -> Dict[str, float]:
    """The worst of each number over the sampled batches. A payload that
    lacks a key, holds one more, differs in a shape or is not finite
    makes every number inf."""
    out: Dict[str, float] = {}
    for got, want in zip(program, expected):
        for name, v in _numbers(got, want).items():
            out[name] = max(out.get(name, 0.0), v)
    return out


def tonal_numbers(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """`TONAL_NUMBERS` of the music extractor's outputs (`music_features`'
    names) against the reference's."""
    def pair(key):
        r = want[key].to(torch.float64)
        return torch.as_tensor(got[key]).to(r.device, torch.float64), r

    return read_numbers(TONAL_NUMBERS, pair)
