"""Plain reference of upstream's content-aware `GenerateFingerprint`
(RyanBlaney/sonido-sonar fingerprint/fingerprint.go:137-236) at its
`DefaultFingerprintConfig` (window 2048, hop 512, fingerprint.go:70-98)
with no metadata on the clips: the acoustic content detector decides
each clip's type (content_detector.go:120-221), the type's row of the
content-config table (content_config.go) sets the feature flags, and the
factory's strict routing (feature_extractor.go:38-62, its music, sports
and mixed cases commented out) gives every clip the speech extractor,
the talk variant for TALK and the news variant for every other type. The
payload is the speech extractor's (speech.go:135-509) at the type's
flags, in the port's `ExtractedFeatures` names.

Plain PyTorch, float32, TF32 off, none of the program's code. It takes
the DFT-matmul magnitudes, MFCC tables, descriptors, sorted-band
contrast and YIN of `fingerprint_features.py` at this configuration's
window and hop, and writes the rest out here from their definitions.

Departures from upstream's description, each the port's documented
semantics (which this reference holds the port to):

- The detector's nine features are float32 tensor math (upstream:
  float64); the spectrum of the first 2048 samples is a DFT matmul
  (upstream: an O(N^2) DFT loop, quirk #7); each feature is classified
  from its float32 value, so a ratio of counts such as 3/10 reads as
  float32(0.3), which is above 0.3. The detector never returns TALK
  (its score is 0.9 of NEWS's) nor MIXED; SPORTS has no row in the
  table and takes UNKNOWN's flags.
- MFCC, the spectral descriptors, rolloff and the band ratios read the
  raw signal's magnitudes (fingerprint.go hands the extractor a raw-PCM
  spectrogram); ZCR, energy, temporal, pitch and the speech chain read
  the signal pre-emphasized at 0.97.
- Energy "entropy" is elementwise -E ln(E + 1e-10); the loudness range
  is p95 - p10 of 400 ms windows (25 % hop) by sorted index; silence is
  the share of frames at or below the 10th-percentile energy (sorted
  index T // 10), pauses the runs of such frames longer than 0.1 s, at
  most 64; onsets the interior maxima of the energy derivative above its
  mean + 2 std, an attack looking back up to 10 frames from the onset's
  derivative index for energy under 10 % of it, at most 0.1 s.
- Pitch is YIN at the fixed 1024/512 (quirk #8), 80-1000 Hz, threshold
  0.15, voicing its confidence. Voice quality is YIN at 1024/256,
  50-500 Hz, a frame voiced when its confidence is over 0.5; jitter and
  shimmer are the mean relative change of the period length and of the
  RMS over the frame's first period between consecutive voiced frames.
- Formants: the first 2048 samples pre-emphasized again at 0.97, a
  symmetric Hamming window, LPC of order 12 + sr/1000 by the textbook
  autocorrelation and Levinson-Durbin, the envelope 1/|A| of the error
  filter over 513 bins, its strongest 12 local maxima over 10 % of its
  maximum, half-height bandwidths, confidence 0.6 amp + 0.4 (1 - bw /
  1000), validated, spaced 200 Hz, the first four kept; the vocal tract
  length from those with confidence over 0.3.
- `is_speech` (ZCR in (0.01, 0.3), RMS over 0.001, the first 1024
  samples' periodicity over 0.1 at lags 20-399) gates the formants,
  voicing, tilt, speech rate, jitter and shimmer; spectral tilt is per
  1024/512 frame.

`compare` reads one content-type mismatch share and, on the clips whose
type matches, one number per group of keys (`NUMBERS`). `lowp=True`
runs every matmul in TF32, the precision below the configuration's
float32: the control.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import fingerprint_features as FF

EPS = 1e-10
ROWS = 16            # clips a block; the reference's peak stays a few GB
DECISION_RTOL = 1e-3
QUANTILE = 0.999

# content_config.go:106-278: each type's feature flags (SPORTS has no row)
FLAGS = {
    "music": dict(mfcc=True, chroma=True, contrast=True, harmonic=True, speech=False, temporal=False),
    "news": dict(mfcc=True, chroma=False, contrast=True, harmonic=False, speech=True, temporal=True),
    "talk": dict(mfcc=True, chroma=False, contrast=True, harmonic=False, speech=True, temporal=True),
    "mixed": dict(mfcc=True, chroma=True, contrast=True, harmonic=True, speech=True, temporal=True),
    "unknown": dict(mfcc=True, chroma=True, contrast=True, harmonic=False, speech=False, temporal=True),
}


def flags(content_type: str) -> dict:
    return FLAGS.get(content_type, FLAGS["unknown"])


def subtype(content_type: str) -> str:
    """The strict factory's speech extractor variant."""
    return "talk" if content_type == "talk" else "news"


# -- the content detector (content_detector.go:120-221) -----------------------

@functools.lru_cache(maxsize=4)
def _dft_plain(n: int) -> np.ndarray:
    """[n, 2F]: Re then Im of the real DFT of n samples, no window."""
    f = n // 2 + 1
    ang = -2.0 * np.pi * np.arange(n, dtype=np.float64)[:, None] * np.arange(f)[None, :] / n
    return np.concatenate([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


def acoustic_features(pcm: torch.Tensor, sr: int) -> torch.Tensor:
    """[B, N] -> [B, 9] float32: zcr, centroid, energy variance, silence
    ratio, dynamic range, low ratio, high ratio, harmonic ratio, temporal
    stability."""
    x = pcm.to(torch.float32)
    b, n = x.shape
    dev = x.device
    nonneg = x >= 0
    zcr = torch.sum(nonneg[:, 1:] != nonneg[:, :-1], dim=-1).to(torch.float64) / (n - 1)

    w = min(2048, n)
    reim = torch.matmul(x[:, :w], FF._t(_dft_plain(w), dev))
    nb = w // 2 + 1
    spec = torch.sqrt(reim[:, :nb] ** 2 + reim[:, nb:] ** 2)
    freqs = torch.arange(nb, device=dev, dtype=torch.float32) * (sr / (nb * 2.0))
    m_sum = torch.sum(spec, dim=-1)
    centroid = torch.where(m_sum > 0, torch.sum(spec * freqs, dim=-1) / torch.clamp_min(m_sum, 1e-12), 0.0)

    sq = x * x
    n_fr = len(range(0, n - 1024, 512))
    evar = x.new_zeros(b)
    if n >= 2048 and n_fr > 1:
        energies = torch.mean(sq.unfold(-1, 1024, 512)[:, :n_fr], dim=-1)
        evar = torch.var(energies, dim=-1, correction=0)

    t_sil = n // 1024
    rms = torch.sqrt(torch.mean(sq[:, : t_sil * 1024].reshape(b, t_sil, 1024), dim=-1))
    silence = torch.mean((rms < 0.01).to(torch.float32), dim=-1)

    a = torch.abs(x)
    mx = torch.amax(a, dim=-1)
    mn = torch.amin(torch.where(a > 1e-10, a, float("inf")), dim=-1)
    dyn = torch.where(torch.isfinite(mn) & (mx > 0), 20.0 * torch.log10(mx / mn), 0.0)

    p = spec * spec
    low, high = torch.sum(p[:, : nb // 4], dim=-1), torch.sum(p[:, nb // 4:], dim=-1)
    tot = low + high
    low_r = torch.where(tot > 0, low / tot, 0.0)
    high_r = torch.where(tot > 0, high / tot, 0.0)

    harmonic = []
    s = spec.cpu().numpy()
    for row in s:
        peaks = [i for i in range(2, nb - 2) if row[i] > row[i - 1] and row[i] > row[i + 1]
                 and row[i] > row[i - 2] and row[i] > row[i + 2]]
        if len(peaks) < 2:
            harmonic.append(0.0)
            continue
        ratio = np.asarray(peaks[1:], dtype=np.float32) / np.float32(peaks[0])
        harm = int(np.sum(np.abs(ratio - np.round(ratio)) < np.float32(0.1)))
        harmonic.append(float(np.float32(harm) / np.float32(len(peaks) - 1)))
    harmonic = torch.tensor(harmonic, dtype=torch.float32, device=dev)

    frame = sr // 10
    stability = x.new_zeros(b)
    if n >= 3 * frame:
        fs = list(range(0, n - frame, frame))
        e = torch.sum(sq[:, : len(fs) * frame].reshape(b, len(fs), frame), dim=-1)
        mean = torch.mean(e, dim=-1)
        cv = torch.sqrt(torch.var(e, dim=-1, correction=0)) / torch.clamp_min(mean, 1e-20)
        if len(fs) > 1:
            stability = torch.where(mean > 0, torch.clamp_min(1.0 - cv, 0.0), 0.0)
    return torch.stack([zcr.to(torch.float32), centroid, evar, silence, dyn, low_r, high_r, harmonic,
                        stability], dim=-1)


def classify(z) -> str:
    """classifyFromFeatures (content_detector.go:156-221) of one row of
    `acoustic_features`, constants verbatim; threshold 2.0 (config.go)."""
    zcr, cent, evar, sil, dyn, _, _, harm, stab = (float(v) for v in z)
    music = (2.0 if zcr < 0.1 else 0.0) + (2.0 if harm > 0.3 else 0.0) + (1.0 if stab > 0.5 else 0.0) \
        + (1.0 if dyn > 20 else 0.0)
    speech = (2.0 if 0.05 < zcr < 0.3 else 0.0) + (2.0 if 800 < cent < 3000 else 0.0) \
        + (1.0 if harm < 0.2 else 0.0) + (1.0 if 0.1 < sil < 0.4 else 0.0)
    sports = (2.0 if evar > 0.3 else 0.0) + (1.5 if dyn > 30 else 0.0) + (1.0 if stab < 0.4 else 0.0)
    best, best_score = "unknown", 2.0
    for ct, score in (("music", music), ("news", speech), ("talk", speech * 0.9), ("sports", sports)):
        if score > best_score:
            best, best_score = ct, score
    return best


def detect(pcm: torch.Tensor, sr: int) -> List[str]:
    return [classify(z) for z in acoustic_features(pcm, sr).cpu().numpy()]


# -- the speech extractor's pieces --------------------------------------------

def pre_emphasis(x: torch.Tensor, a: float = 0.97) -> torch.Tensor:
    return x - a * F.pad(x[..., :-1], (1, 0))


def frame_rms(x: torch.Tensor, w: int, hop: int) -> torch.Tensor:
    f = x.unfold(-1, w, hop)
    return torch.sqrt(torch.mean(f * f, dim=-1))


def loudness_range(x: torch.Tensor, sr: int) -> torch.Tensor:
    w = int(0.4 * sr)
    rms = frame_rms(x, w, max(w // 4, 1))
    loud = torch.where(rms > 0, -0.691 + 10.0 * torch.log10(torch.clamp_min(rms * rms, EPS)), -70.0)
    t = loud.shape[-1]
    s = torch.sort(loud, dim=-1).values
    return s[..., int(0.95 * (t - 1))] - s[..., int(0.10 * (t - 1))]


def tenth(e: torch.Tensor) -> torch.Tensor:
    t = e.shape[-1]
    return torch.sort(e, dim=-1).values[..., t // 10: t // 10 + 1]


def pauses(e: torch.Tensor, hop: int, sr: int, max_pauses: int = 64, min_s: float = 0.1):
    """Runs of frames at or below the 10th-percentile energy, in order."""
    silent = (e <= tenth(e)).cpu().numpy()
    durs = np.zeros((e.shape[0], max_pauses), dtype=np.float32)
    counts = np.zeros(e.shape[0], dtype=np.int32)
    for r, row in enumerate(silent):
        run = 0
        for i, s in enumerate(row.tolist() + [False]):
            if s:
                run += 1
                continue
            d = np.float32(run) * np.float32(hop / float(sr))
            if run and d > min_s and counts[r] < max_pauses:
                durs[r, counts[r]] = d
                counts[r] += 1
            run = 0
    return torch.from_numpy(durs).to(e.device), torch.from_numpy(counts).to(e.device)


def onsets(e: torch.Tensor, hop: int, sr: int, lookback: int = 10):
    """(mask over the derivative's index, count, attack times)."""
    d = e[..., 1:] - e[..., :-1]
    thr = torch.mean(d, dim=-1, keepdim=True) + 2.0 * torch.std(d, dim=-1, correction=0, keepdim=True)
    inner = (d[..., 1:-1] > d[..., :-2]) & (d[..., 1:-1] > d[..., 2:]) & (d[..., 1:-1] > thr)
    mask = F.pad(inner, (1, 1))
    m, t = mask.shape[-1], e.shape[-1]
    i = torch.arange(m, device=e.device)
    attack = torch.zeros_like(d)
    for l in range(lookback, 0, -1):     # the nearest frame under 10 % wins
        j = i - l
        ok = (j >= 0) & (e[..., torch.clamp(j, 0, t - 1)] < 0.1 * e[..., i])
        attack = torch.where(ok, float(min(np.float32(l) * np.float32(hop / float(sr)), np.float32(0.1))),
                             attack)
    return mask, torch.sum(mask, dim=-1), torch.where(mask, attack, 0.0)


def is_speech(x: torch.Tensor, sr: int) -> torch.Tensor:
    n = x.shape[-1]
    if n < sr // 4:
        return torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    nonneg = x >= 0
    zcr = torch.mean((nonneg[..., 1:] != nonneg[..., :-1]).to(torch.float32), dim=-1)
    energy = torch.sqrt(torch.mean(x * x, dim=-1))
    fr = x[..., :1024]
    lags = torch.arange(400, device=x.device)
    ac = torch.stack([torch.sum(fr[..., : 1024 - l] * fr[..., l:], dim=-1) for l in range(400)], dim=-1)
    ac = ac / (1024.0 - lags.to(torch.float32))
    best = torch.amax(ac[..., 20:], dim=-1)
    fe = torch.mean(fr * fr, dim=-1)
    periodic = torch.where(fe > 0, best / torch.clamp_min(fe, EPS), 0.0)
    return (zcr > 0.01) & (zcr < 0.3) & (energy > 0.001) & (periodic > 0.1)


@functools.lru_cache(maxsize=4)
def hamming(n: int) -> np.ndarray:
    return (0.54 - 0.46 * np.cos(2 * np.pi * np.arange(n, dtype=np.float64) / (n - 1))).astype(np.float32)


def levinson(r: torch.Tensor, p: int) -> torch.Tensor:
    """Levinson-Durbin in float32 over rows: a [R, p+1], a[0] = 1, a[i] the
    i-th predictor coefficient (x[n] ~ sum a_i x[n-i])."""
    a = r.new_zeros((r.shape[0], p + 1))
    a[:, 0] = 1.0
    e = torch.clamp_min(r[:, 0], EPS)
    for i in range(1, p + 1):
        num = r[:, i] - sum(a[:, j] * r[:, i - j] for j in range(1, i)) if i > 1 else r[:, i]
        k = num / torch.clamp_min(e, EPS)
        prev = a.clone()
        for j in range(1, i):
            a[:, j] = prev[:, j] - k * prev[:, i - j]
        a[:, i] = k
        e = torch.clamp_min(e * (1.0 - k * k), EPS)
    return a


def formants(x: torch.Tensor, sr: int, max_formants: int = 4, nfft: int = 1024):
    """(frequencies [R, 4], count [R], vocal tract length [R])."""
    w = 2048 if sr > 22050 else 1024
    p = 12 + sr // 1000
    dev = x.device
    fr = pre_emphasis(x[..., :w].to(torch.float32)) * FF._t(hamming(w), dev)
    r = torch.stack([torch.sum(fr[..., : w - k] * fr[..., k:], dim=-1) for k in range(p + 1)], dim=-1)
    a = levinson(r, p)
    afilt = torch.cat([a[:, :1], -a[:, 1:]], dim=-1)
    kk = torch.arange(nfft // 2 + 1, dtype=torch.float32, device=dev)
    ii = torch.arange(p + 1, dtype=torch.float32, device=dev)
    ang = -ii[:, None] * (2.0 * math.pi * kk / nfft)[None, :]
    re = torch.sum(afilt[:, :, None] * torch.cos(ang), dim=1)
    im = torch.sum(afilt[:, :, None] * torch.sin(ang), dim=1)
    mag = torch.sqrt(re * re + im * im)
    env = torch.where(mag > 0, 1.0 / torch.clamp_min(mag, EPS), 0.0).cpu().numpy()
    res = sr / float(nfft)
    nb = env.shape[-1]
    freqs = np.zeros((env.shape[0], max_formants), dtype=np.float32)
    counts = np.zeros(env.shape[0], dtype=np.int32)
    vtl = np.full(env.shape[0], 17.5, dtype=np.float32)
    for row, e in enumerate(env):
        top = e.max()
        peaks = [i for i in range(1, nb - 1) if e[i] > e[i - 1] and e[i] > e[i + 1]
                 and e[i] / max(top, np.float32(EPS)) > np.float32(0.1) and 50.0 <= i * res <= sr / 2.0]
        peaks = sorted(peaks, key=lambda i: (-e[i], i))[: 3 * max_formants]
        cands = []
        for i in peaks:
            amp = e[i]
            left = [j for j in range(i - 1, -1, -1) if e[j] <= amp / np.float32(2.0)]
            right = [j for j in range(i + 1, nb) if e[j] <= amp / np.float32(2.0)]
            bw = np.float32(((i - left[0]) if left else i) + ((right[0] - i) if right else nb - 1 - i)) \
                * np.float32(res)
            conf = np.float32(0.6) * (amp / top if top > 0 else np.float32(0.0)) \
                + np.float32(0.4) * np.float32(min(max(1.0 - bw / np.float32(1000.0), 0.0), 1.0))
            f = np.float32(i) * np.float32(res)
            if f >= 50.0 and conf >= 0.2 and 0 < bw <= 1000.0:
                cands.append((f, conf))
        kept, last = [], -1e9
        for f, conf in sorted(cands, key=lambda c: c[0]):
            if f - last >= 200.0:
                kept.append((f, conf))
                last = f
        kept = kept[:max_formants]
        counts[row] = len(kept)
        use = []
        for n, (f, conf) in enumerate(kept, start=1):
            freqs[row, n - 1] = f
            v = np.float32(2 * n - 1) * np.float32(35000.0) / (np.float32(4.0) * max(f, np.float32(EPS)))
            if f > 0 and conf > 0.3 and 10.0 <= v <= 25.0:
                use.append(v)
        if use:
            vtl[row] = np.float32(sum(use, np.float32(0.0)) / np.float32(len(use)))
    return (torch.from_numpy(freqs).to(dev), torch.from_numpy(counts).to(dev), torch.from_numpy(vtl).to(dev))


def _reldiff(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    pair = m[..., 1:] & m[..., :-1]
    n_pairs = torch.sum(pair, dim=-1)
    mean_d = torch.sum(torch.where(pair, torch.abs(v[..., 1:] - v[..., :-1]), 0.0), dim=-1) \
        / torch.clamp_min(n_pairs, 1)
    mean_v = torch.sum(torch.where(m, v, 0.0), dim=-1) / torch.clamp_min(torch.sum(m, dim=-1), 1)
    return torch.where((n_pairs > 0) & (mean_v > EPS), mean_d / torch.clamp_min(mean_v, EPS) * 100.0, 0.0)


def voice_quality(x: torch.Tensor, sr: int):
    """(jitter, shimmer) over YIN at 1024/256, 50-500 Hz."""
    pitch, conf = FF.yin(x, 1024, 256, sr, 50.0, 500.0)
    voiced = (conf > 0.5) & (pitch >= 50.0) & (pitch <= 500.0)
    period = torch.where(pitch > 0, torch.full_like(pitch, float(sr)) / torch.clamp_min(pitch, EPS), 0.0)
    frames = x.unfold(-1, 1024, 256)
    plen = torch.clamp(period.to(torch.int32), 1, 1023)
    j = torch.arange(1024, device=x.device)
    amp = torch.sqrt(torch.sum(torch.where(j < plen[..., None], frames * frames, 0.0), dim=-1)
                     / plen.to(torch.float32))
    plen_v = torch.where(voiced, period, 0.0)
    return _reldiff(plen_v, voiced), _reldiff(amp, voiced)


def tilt(x: torch.Tensor) -> torch.Tensor:
    fr = x.unfold(-1, 1024, 512)
    d = fr[..., 1:] - fr[..., :-1]
    high = torch.sum(d * d, dim=-1)
    low = torch.sum(fr[..., 1:] * fr[..., 1:], dim=-1)
    return torch.where(low > 0, -10.0 * torch.log10(torch.clamp_min(high / torch.clamp_min(low, EPS), EPS)),
                       0.0)


def payload_block(pcm: torch.Tensor, cfg: dict, fl: dict) -> Dict[str, torch.Tensor]:
    """The speech extractor's payload of [R, N] clips of one type, by
    `ExtractedFeatures` field path."""
    sr, w, hop = int(cfg["sample_rate"]), int(cfg["window_size"]), int(cfg["hop_size"])
    x = pcm.to(torch.float32)
    pre = pre_emphasis(x, float(cfg["pre_emphasis"]))
    m = FF.magnitudes(x, w, hop)
    power = m * m
    nb = m.shape[-1]
    out: Dict[str, torch.Tensor] = {}
    if fl["mfcc"]:
        dct, lift = FF.dct_lifter(int(cfg["mfcc_coefficients"]), 26)
        mel = torch.matmul(power, FF._t(FF.mel_bank(26, w, sr), m.device).T)
        out["mfcc"] = torch.matmul(torch.log(torch.clamp_min(mel, FF.LOG_FLOOR)), FF._t(dct, m.device).T) \
            * FF._t(lift, m.device)
    d = FF.descriptors(m, sr)
    p_sum = torch.sum(power, dim=-1)
    reached = torch.cumsum(power, dim=-1) >= FF.ROLLOFF * p_sum[..., None]
    first = torch.where(torch.any(reached, dim=-1), torch.argmax(reached.to(torch.uint8), dim=-1), nb - 1)
    pos = p_sum > 0
    frames = pre.unfold(-1, w, hop)
    nonneg = frames >= 0
    crossings = torch.sum(nonneg[..., 1:] != nonneg[..., :-1], dim=-1).to(torch.float32)
    sp = "spectral_features."
    out.update({sp + k: d[k] for k in ("spectral_centroid", "spectral_bandwidth", "spectral_flatness",
                                       "spectral_crest", "spectral_slope", "spectral_flux")})
    out[sp + "spectral_rolloff"] = torch.where(pos, first.to(torch.float32), 0.0) * ((sr / 2.0) / float(nb - 1))
    out[sp + "zero_crossing_rate"] = crossings * float(np.float32(1.0) / np.float32(w / float(sr)))
    if fl["contrast"]:
        out[sp + "spectral_contrast"] = FF.contrast(m, sr, int(cfg["contrast_bands"]))

    ste = torch.sqrt(torch.mean(frames * frames, dim=-1))
    t = ste.shape[-1]
    mean = torch.mean(ste, dim=-1, keepdim=True)
    lr = loudness_range(pre, sr)
    den = torch.clamp_min(p_sum, EPS)
    en = "energy_features."
    out[en + "short_time_energy"] = ste
    out[en + "energy_variance"] = torch.sum((ste - mean) ** 2, dim=-1) / (t - 1)
    out[en + "energy_entropy"] = torch.where(ste > 0, -ste * torch.log(ste + 1e-10), 0.0)
    out[en + "loudness_range"] = lr
    out[en + "low_energy_ratio"] = torch.where(pos, torch.sum(power[..., : nb // 4], dim=-1) / den, 0.0)
    out[en + "high_energy_ratio"] = torch.where(pos, torch.sum(power[..., nb // 4:], dim=-1) / den, 0.0)

    silence = torch.mean((ste <= tenth(ste)).to(torch.float32), dim=-1)
    if fl["temporal"]:
        mask, count, attack = onsets(ste, hop, sr)
        tp = "temporal_features."
        out[tp + "rms_energy"] = ste
        out[tp + "peak_amplitude"] = torch.amax(torch.abs(pre), dim=-1)
        out[tp + "average_amplitude"] = torch.mean(torch.abs(pre), dim=-1)
        out[tp + "dynamic_range"] = lr
        out[tp + "silence_ratio"] = silence
        out[tp + "onset_density"] = count.to(torch.float32) / (x.shape[-1] / float(sr))
        out[tp + "onset_mask"] = mask
        out[tp + "attack_time"] = attack
        out[tp + "envelope_shape"] = frame_rms(pre, 512, 256)

    pitch, conf = FF.yin(pre, int(cfg["pitch_window"]), int(cfg["pitch_hop"]), sr)
    hp = "harmonic_features."
    out[hp + "pitch_estimate"] = pitch
    out[hp + "pitch_confidence"] = conf
    out[hp + "voicing_strength"] = conf
    out[hp + "harmonic_ratio"] = conf * 10.0
    out[hp + "inharmonicity_ratio"] = 1.0 - conf
    out[hp + "tonal_centroid"] = torch.where(pitch > 0, pitch, 0.0)

    if fl["speech"]:
        speaking = is_speech(pre, sr)
        freqs, count, vtl = formants(pre, sr)
        jitter, shimmer = voice_quality(pre, sr)
        dur, n_pauses = pauses(ste, hop, sr)
        s1 = speaking[..., None]
        sf = "speech_features."
        out[sf + "formant_frequencies"] = torch.where(s1, freqs, 0.0)[..., None, :]
        out[sf + "formant_count"] = torch.where(speaking, count, 0)
        out[sf + "vocal_tract_length"] = torch.where(speaking, vtl, 17.5)
        out[sf + "voicing_probability"] = torch.where(s1, conf, 0.0)
        out[sf + "spectral_tilt"] = torch.where(s1, tilt(pre), 0.0)
        out[sf + "speech_rate"] = torch.where(speaking, 4.0 * (1.0 - silence), 0.0)
        out[sf + "pause_duration"] = dur
        out[sf + "pause_count"] = n_pauses
        out[sf + "jitter"] = torch.where(speaking, jitter, 0.0)
        out[sf + "shimmer"] = torch.where(speaking, shimmer, 0.0)
    return out


def fingerprints(pcm: torch.Tensor, cfg: dict, lowp: bool = False) -> dict:
    """[B, N] clips -> {"types": [B] str, "subtypes": [B] str, "rows": [B]
    dicts of each clip's payload by field path}."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(lowp)
    try:
        sr = int(cfg["sample_rate"])
        types = detect(pcm, sr)
        rows: List[dict] = [{} for _ in types]
        for ct in dict.fromkeys(types):
            idx = [i for i, c in enumerate(types) if c == ct]
            for lo in range(0, len(idx), ROWS):
                part = idx[lo: lo + ROWS]
                out = payload_block(pcm[torch.tensor(part, device=pcm.device)], cfg, flags(ct))
                for pos, i in enumerate(part):
                    rows[i] = {k: v[pos] for k, v in out.items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return {"types": types, "subtypes": [subtype(c) for c in types], "rows": rows}


# -- the comparison -----------------------------------------------------------

SP, EN, TP, HP, SF = ("spectral_features.", "energy_features.", "temporal_features.",
                      "harmonic_features.", "speech_features.")
# number -> (how it reads, the field paths it reads), each over the clips
# whose type matches. "gap": the largest |difference| over the key's
# largest |reference value|, the worst key; "quantile": the 99.9th
# percentile of that ratio (keys that take the log of every bin, as in
# the backfill); "flips": the share of frames that differ by more than
# DECISION_RTOL of the key's largest value, the worst key (a YIN pick, a
# sign-change count, the first bin past 85 % of the power); "share": the
# same share over every entry of the group's keys together (per-clip
# decisions: onsets, formant picks, pauses, and jitter and shimmer, which
# one voiced frame more or less moves); "is_speech": the share of clips
# whose payload shows is_speech set on one side only.
NUMBERS = {
    "mfcc_gap": ("gap", ("mfcc",)),
    "spectral_centroid_gap": ("gap", (SP + "spectral_centroid",)),
    "spectral_bandwidth_gap": ("gap", (SP + "spectral_bandwidth",)),
    "spectral_crest_gap": ("gap", (SP + "spectral_crest",)),
    "spectral_flux_gap": ("gap", (SP + "spectral_flux",)),
    "spectral_contrast_gap": ("gap", (SP + "spectral_contrast",)),
    "spectral_flatness_q999_gap": ("quantile", (SP + "spectral_flatness",)),
    "spectral_slope_q999_gap": ("quantile", (SP + "spectral_slope",)),
    "energy_gap": ("gap", (EN + "short_time_energy", EN + "energy_variance", EN + "energy_entropy",
                           EN + "low_energy_ratio", EN + "high_energy_ratio", TP + "rms_energy")),
    "temporal_gap": ("gap", (EN + "loudness_range", TP + "dynamic_range", TP + "peak_amplitude",
                             TP + "average_amplitude", TP + "silence_ratio", TP + "envelope_shape",
                             SF + "speech_rate")),
    "decision_flips": ("flips", (SP + "zero_crossing_rate", SP + "spectral_rolloff", HP + "pitch_estimate",
                                 HP + "pitch_confidence", HP + "voicing_strength", HP + "harmonic_ratio",
                                 HP + "inharmonicity_ratio", HP + "tonal_centroid",
                                 SF + "voicing_probability")),
    "onset_flips": ("share", (TP + "onset_mask", TP + "attack_time", TP + "onset_density")),
    "is_speech_flips": ("is_speech", ()),
    "formant_flips": ("share", (SF + "formant_frequencies", SF + "formant_count", SF + "vocal_tract_length")),
    "spectral_tilt_gap": ("gap", (SF + "spectral_tilt",)),
    "voice_quality_flips": ("share", (SF + "jitter", SF + "shimmer")),
    "pause_flips": ("share", (SF + "pause_duration", SF + "pause_count")),
}


def _is_speech_seen(row: dict):
    """Whether a clip's payload shows is_speech set: its gated tilt,
    speech rate or formant count is nonzero (None without speech keys)."""
    if SF + "spectral_tilt" not in row:
        return None
    return bool(torch.any(torch.as_tensor(row[SF + "spectral_tilt"]) != 0)
                or float(row[SF + "speech_rate"]) != 0 or int(row[SF + "formant_count"]) != 0)


def _paired(got: dict, want: dict, matched: List[int], key: str):
    """(program, reference) float64 stacks of `key` over the matched clips
    that carry it; None where none does."""
    idx = [i for i in matched if key in want["rows"][i]]
    if not idx:
        return None
    r = torch.stack([want["rows"][i][key] for i in idx]).to(torch.float64)
    g = torch.stack([torch.as_tensor(got["rows"][i][key]) for i in idx]).to(r.device, torch.float64)
    return g, r


def _structure_ok(got: dict, want: dict) -> bool:
    if len(got.get("types", [])) != len(want["types"]) or len(got.get("rows", [])) != len(want["rows"]):
        return False
    for i, (gt, wt) in enumerate(zip(got["types"], want["types"])):
        if gt != wt:
            continue
        g, w = got["rows"][i], want["rows"][i]
        if set(g) != set(w):
            return False
        for k, v in w.items():
            a = torch.as_tensor(g[k])
            if tuple(a.shape) != tuple(v.shape) or (a.is_floating_point() and not bool(torch.isfinite(a).all())):
                return False
    return True


def _numbers(got: dict, want: dict) -> Dict[str, float]:
    if not _structure_ok(got, want):
        return {name: float("inf") for name in ("content_type_mismatches",) + tuple(NUMBERS)}
    b = len(want["types"])
    matched = [i for i in range(b) if (got["types"][i], got["subtypes"][i])
               == (want["types"][i], want["subtypes"][i])]
    out = {"content_type_mismatches": (b - len(matched)) / b}
    for name, (how, keys) in NUMBERS.items():
        if how == "is_speech":
            seen = [(_is_speech_seen(got["rows"][i]), _is_speech_seen(want["rows"][i])) for i in matched]
            seen = [(g, w) for g, w in seen if w is not None]
            out[name] = sum(g != w for g, w in seen) / len(seen) if seen else 0.0
            continue
        worst, differ, total = 0.0, 0, 0
        for key in keys:
            pr = _paired(got, want, matched, key)
            if pr is None:
                continue
            g, r = pr
            scale = max(float(torch.amax(torch.abs(r))), 1e-30)
            if how == "gap":
                worst = max(worst, float(torch.amax(torch.abs(g - r))) / scale)
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


def compare(program: List[dict], expected: List[dict]) -> Dict[str, float]:
    """The worst of each number over the sampled batches. A payload that
    lacks a key, holds one more, differs in a shape or is not finite on a
    clip whose type matches makes every number inf."""
    out: Dict[str, float] = {}
    for got, want in zip(program, expected):
        for name, v in _numbers(got, want).items():
            out[name] = max(out.get(name, 0.0), v)
    return out
