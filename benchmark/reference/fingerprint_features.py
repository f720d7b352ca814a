"""Plain reference of `batched_fingerprint_features` (the port's main
path: K1's magnitudes and aux series, MFCC, chroma, the spectral
descriptors, 6-band contrast, the energy series and K2's YIN pitch) at
its defaults: 44.1 kHz, window 1024, hop 256, Hann, 13 MFCC, pitch at
1024/512, pre-emphasis 0.97.

Plain PyTorch, none of the program's code: a frozen copy of the port's
plain math (its documented semantics: the symmetric power-normalized
Hann window, the DFT as a float32 matmul against the windowed basis,
the mel and chroma fold tables, the orthonormal DCT-II and lifter, the
descriptor masks, the sorted-band contrast, YIN's difference function by
DFT matmuls, CMNDF, the threshold pick and its parabola). The tables are
built here in float64 from their definitions. Rows go through in blocks
of `ROWS` clips, so the reference's peak stays a few GB.

`lowp=True` runs every matmul in TF32 (the precision below the float32
the configuration states): the control.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-10
LOG_FLOOR = 1e-10
ROLLOFF = 0.85
INV_LN10 = 0.43429448190325176
ROWS = 32

# the port's output keys (parallel/pipeline.batched_fingerprint_features)
KEYS = ("mfcc", "chroma", "spectral_centroid", "spectral_bandwidth", "spectral_flatness",
        "spectral_crest", "spectral_slope", "spectral_flux", "spectral_contrast", "zcr",
        "spectral_rolloff", "low_energy_ratio", "high_energy_ratio", "rms_energy",
        "energy_entropy", "energy_variance", "pitch", "pitch_confidence", "voicing")
# The numbers compared. Each continuous key reads its largest |difference|
# over its largest |reference value| (`<key>_gap`); the energy series read
# as one number. Spectral flatness and slope read the 99.9th percentile
# of their relative differences: both take the log of every bin, and a
# frame whose spectrum dips to ~1e-6 at some bin moves with the
# transform's float32 rounding there. The keys that carry a decision per
# frame (a sign-change count, the first bin past 85 % of the power, YIN's
# pick of a dip and its value there) read as one share of frames that
# differ by more than DECISION_RTOL of the key's largest value: a pick
# near the threshold moves with the last bits of the spectrum (PERF.md).
GAP_KEYS = ("mfcc", "chroma", "spectral_centroid", "spectral_bandwidth", "spectral_crest",
            "spectral_flux", "spectral_contrast")
QUANTILE_KEYS = ("spectral_flatness", "spectral_slope")
ENERGY_KEYS = ("rms_energy", "energy_entropy", "energy_variance", "low_energy_ratio", "high_energy_ratio")
DECISION_KEYS = ("zcr", "spectral_rolloff", "pitch", "pitch_confidence", "voicing")
QUANTILE = 0.999
DECISION_RTOL = 1e-3


# -- tables, float64 from their definitions -------------------------------

@functools.lru_cache(maxsize=8)
def hann(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2 * np.pi * i / (n - 1)))
    return w / np.sqrt(np.mean(w * w))


@functools.lru_cache(maxsize=8)
def dft_basis(n: int) -> np.ndarray:
    """[W, 2F]: Re then Im of the real DFT, each row scaled by the window."""
    f = n // 2 + 1
    ang = -2.0 * np.pi * np.arange(n, dtype=np.float64)[:, None] * np.arange(f)[None, :] / n
    return (np.concatenate([np.cos(ang), np.sin(ang)], axis=1) * hann(n)[:, None]).astype(np.float32)


def _hz_to_mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


def _mel_to_hz(mel):
    return 700.0 * (np.power(10.0, np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_bank(filters: int, n_fft: int, sr: int) -> np.ndarray:
    """Triangular filters, bins rounded as floor((n_fft + 1) f / sr + 0.5)
    and clamped to n_fft / 2 (mfcc.go, mel_scale.go)."""
    pts = _hz_to_mel(0.0) + (_hz_to_mel(sr / 2.0) - _hz_to_mel(0.0)) / (filters + 1) * np.arange(filters + 2)
    bins = np.minimum(np.floor((n_fft + 1.0) * _mel_to_hz(pts) / sr + 0.5).astype(np.int64), n_fft // 2)
    nb = n_fft // 2 + 1
    fb = np.zeros((filters, nb))
    for m in range(1, filters + 1):
        lo, c, hi = bins[m - 1], bins[m], bins[m + 1]
        if c != lo:
            k = np.arange(lo, min(c, nb))
            fb[m - 1, k] = (k - lo) / float(c - lo)
        if hi != c:
            k = np.arange(c, min(hi, nb))
            fb[m - 1, k] = (hi - k) / float(hi - c)
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=8)
def dct_lifter(c: int, m: int, lifter: float = 22.0) -> np.ndarray:
    """Orthonormal DCT-II [C, M] with the lifter 1 + (L/2) sin(pi i / L)
    (C0 unliftered) applied to its rows."""
    k = np.arange(c, dtype=np.float64)[:, None]
    n = np.arange(m, dtype=np.float64)[None, :]
    d = np.cos(np.pi * k * (n + 0.5) / m)
    d[0] *= np.sqrt(1.0 / m)
    d[1:] *= np.sqrt(2.0 / m)
    lift = 1.0 + (lifter / 2.0) * np.sin(np.pi * np.arange(c) / lifter)
    lift[0] = 1.0
    return d.astype(np.float32), lift.astype(np.float32)


@functools.lru_cache(maxsize=8)
def chroma_fold(nb: int, sr: int, n_fft: int) -> np.ndarray:
    """[12, F]: bin f to pitch class round(69 + 12 log2(f / 440)) mod 12,
    80 Hz to 8 kHz."""
    fold = np.zeros((12, nb), dtype=np.float32)
    for f in range(1, nb):
        hz = f * sr / float(n_fft)
        if 80.0 <= hz <= 8000.0:
            fold[int(round(69.0 + 12.0 * np.log2(hz / 440.0))) % 12, f] = 1.0
    return fold


@functools.lru_cache(maxsize=8)
def freqs(nb: int, sr: int) -> np.ndarray:
    return (np.arange(nb, dtype=np.float64) * (sr / 2.0) / (nb - 1)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def contrast_edges(bands: int, nb: int, sr: int) -> tuple:
    ny = sr / 2.0
    lo, hi = np.log10(200.0), np.log10(ny if ny > 200.0 else 400.0)
    e = [min(max(int(10.0 ** (lo + i * (hi - lo) / bands) * (nb - 1) / ny), 0), nb - 1)
         for i in range(bands + 1)]
    for i in range(1, bands + 1):
        if e[i] <= e[i - 1]:
            e[i] = e[i - 1] + 1
    return tuple(e)


@functools.lru_cache(maxsize=8)
def yin_mats(w: int):
    """(M_x [W, 2F], M_first [W/2, 2F], M_inv [2F, W/2]): the real DFT of
    a frame and of its first half, and the inverse that gives r(tau)."""
    h, nf = w // 2, w // 2 + 1
    k = np.arange(nf, dtype=np.float64)[None, :]
    ax = -2.0 * np.pi * np.arange(w, dtype=np.float64)[:, None] * k / w
    af = -2.0 * np.pi * np.arange(h, dtype=np.float64)[:, None] * k / w
    wk = np.full((nf, 1), 2.0)
    wk[0, 0] = wk[-1, 0] = 1.0
    ai = 2.0 * np.pi * np.arange(nf, dtype=np.float64)[:, None] * np.arange(h)[None, :] / w
    inv = np.concatenate([wk * np.cos(ai), -wk * np.sin(ai)], axis=0) / w
    return tuple(m.astype(np.float32) for m in (np.concatenate([np.cos(ax), np.sin(ax)], 1),
                                                 np.concatenate([np.cos(af), np.sin(af)], 1), inv))


def _t(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


# -- the features ------------------------------------------------------------

def pre_emphasis(x: torch.Tensor, a: float) -> torch.Tensor:
    return x - a * F.pad(x[..., :-1], (1, 0))


def magnitudes(x: torch.Tensor, w: int, hop: int) -> torch.Tensor:
    frames = x.unfold(-1, w, hop)
    reim = torch.matmul(frames, _t(dft_basis(w), x.device))
    nb = w // 2 + 1
    re, im = reim[..., :nb], reim[..., nb:]
    return torch.sqrt(re * re + im * im)


def descriptors(m: torch.Tensor, sr: int) -> Dict[str, torch.Tensor]:
    nb = m.shape[-1]
    f = _t(freqs(nb, sr), m.device)
    m_sum = torch.sum(m, dim=-1)
    p_sum = torch.sum(m * m, dim=-1)
    log_m = torch.log(torch.clamp_min(m, EPS))
    valid = m > EPS
    count = torch.sum(valid, dim=-1)
    logf = torch.where(f > 0, torch.log10(torch.clamp_min(f, EPS)), 0.0)
    vs = valid & (f > 0)
    y = torch.where(vs, log_m * INV_LN10, 0.0)
    ns = torch.sum(vs, dim=-1).to(torch.float32)
    sx = torch.sum(torch.where(vs, logf, 0.0), dim=-1)
    sy = torch.sum(y, dim=-1)
    sxy = torch.sum(y * logf, dim=-1)
    sxx = torch.sum(torch.where(vs, logf * logf, 0.0), dim=-1)
    centroid = torch.where(m_sum > 0, torch.sum(m * f, dim=-1) / torch.clamp_min(m_sum, EPS), 0.0)
    arith = m_sum / nb
    geo = torch.exp(torch.sum(torch.where(valid, log_m, 0.0), dim=-1) / torch.clamp_min(count, 1))
    rms = torch.sqrt(p_sum / nb)
    den = ns * sxx - sx * sx
    ok = torch.abs(den) > EPS
    diff = f - centroid[..., None]
    flux = torch.sqrt(torch.sum(torch.clamp_min(m[..., 1:, :] - m[..., :-1, :], 0.0) ** 2, dim=-1))
    return {
        "spectral_centroid": centroid,
        "spectral_bandwidth": torch.where(m_sum > 0, torch.sqrt(torch.sum(diff * diff * m, dim=-1)
                                                                / torch.clamp_min(m_sum, EPS)), 0.0),
        "spectral_flatness": torch.where((count > 0) & (arith > EPS), geo / torch.clamp_min(arith, EPS), 0.0),
        "spectral_crest": torch.where(rms > 0, torch.amax(m, dim=-1) / torch.clamp_min(rms, EPS), 0.0),
        "spectral_slope": torch.where((ns >= 2) & ok, (ns * sxy - sx * sy) / torch.where(ok, den, 1.0), 0.0),
        "spectral_flux": F.pad(flux, (1, 0)),
    }


def contrast(m: torch.Tensor, sr: int, bands: int = 6) -> torch.Tensor:
    nb = m.shape[-1]
    e = contrast_edges(bands, nb, sr)
    p = m * m
    outs = []
    for b in range(bands):
        lo, hi = e[b], min(e[b + 1], nb)
        if lo >= hi:
            outs.append(m.new_zeros(m.shape[:-1]))
            continue
        width = hi - lo
        k = max(int(0.2 * width), 1)
        s = torch.sort(p[..., lo:hi], dim=-1).values
        valley = torch.clamp_min(torch.mean(s[..., :k], dim=-1), EPS)
        peak = torch.mean(s[..., width - k:], dim=-1)
        outs.append(torch.where(peak > 0, 10.0 * torch.log10(peak / valley), 0.0))
    return torch.stack(outs, dim=-1)


def yin(x: torch.Tensor, w: int, hop: int, sr: int, fmin: float = 80.0, fmax: float = 1000.0,
        threshold: float = 0.15):
    frames = x.unfold(-1, w, hop)
    h, nf = w // 2, w // 2 + 1
    mx, mf, mi = (_t(a, x.device) for a in yin_mats(w))
    first = frames[..., :h]
    e1 = torch.sum(first * first, dim=-1, keepdim=True)
    c0 = F.pad(torch.cumsum(frames * frames, dim=-1), (1, 0))
    s = c0[..., h: 2 * h] - c0[..., :h]
    fx = torch.matmul(frames, mx)
    ff = torch.matmul(first, mf)
    cross = torch.cat([ff[..., :nf] * fx[..., :nf] + ff[..., nf:] * fx[..., nf:],
                       ff[..., :nf] * fx[..., nf:] - ff[..., nf:] * fx[..., :nf]], dim=-1)
    d = e1 + s - 2.0 * torch.matmul(cross, mi)
    tau = torch.arange(1, h, dtype=torch.float32, device=x.device)
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
    conf = torch.where(good, 1.0 - y1, 0.0)
    return torch.where(good, freq, 0.0), conf


def features_block(pcm: torch.Tensor, cfg: dict) -> Dict[str, torch.Tensor]:
    sr, w, hop = int(cfg["sample_rate"]), int(cfg["window_size"]), int(cfg["hop_size"])
    a = float(cfg["pre_emphasis"])
    x = pre_emphasis(pcm.to(torch.float32), a)
    m = magnitudes(x, w, hop)
    power = m * m
    nb = m.shape[-1]
    dct, lift = dct_lifter(int(cfg["mfcc_coefficients"]), 26)
    mel = torch.matmul(power, _t(mel_bank(26, w, sr), m.device).T)
    out = {"mfcc": torch.matmul(torch.log(torch.clamp_min(mel, LOG_FLOOR)), _t(dct, m.device).T)
           * _t(lift, m.device)}
    energy = torch.matmul(power, _t(chroma_fold(nb, sr, w), m.device).T)
    tot = torch.sum(energy, dim=-1, keepdim=True)
    out["chroma"] = torch.where(tot > EPS, energy / torch.clamp_min(tot, EPS), energy)
    out.update(descriptors(m, sr))
    out["spectral_contrast"] = contrast(m, sr, 6)
    frames = x.unfold(-1, w, hop)
    nonneg = frames >= 0
    crossings = torch.sum(nonneg[..., 1:] != nonneg[..., :-1], dim=-1).to(torch.float32)
    out["zcr"] = crossings * float(np.float32(1.0) / np.float32(w / float(sr)))
    p_sum = torch.sum(power, dim=-1)
    reached = torch.cumsum(power, dim=-1) >= ROLLOFF * p_sum[..., None]
    first = torch.where(torch.any(reached, dim=-1), torch.argmax(reached.to(torch.uint8), dim=-1), nb - 1)
    pos = p_sum > 0
    out["spectral_rolloff"] = torch.where(pos, first.to(torch.float32), 0.0) * ((sr / 2.0) / float(nb - 1))
    den = torch.clamp_min(p_sum, EPS)
    split = nb // 4
    out["low_energy_ratio"] = torch.where(pos, torch.sum(power[..., :split], dim=-1) / den, 0.0)
    out["high_energy_ratio"] = torch.where(pos, torch.sum(power[..., split:], dim=-1) / den, 0.0)
    rms = torch.sqrt(torch.mean(frames * frames, dim=-1))
    out["rms_energy"] = rms
    out["energy_entropy"] = torch.where(rms > 0, -rms * torch.log(rms + 1e-10), 0.0)
    mean = torch.mean(rms, dim=-1, keepdim=True)
    out["energy_variance"] = torch.sum((rms - mean) ** 2, dim=-1) / (rms.shape[-1] - 1)
    pitch, conf = yin(x, int(cfg["pitch_window"]), int(cfg["pitch_hop"]), sr)
    out["pitch"], out["pitch_confidence"], out["voicing"] = pitch, conf, conf
    return out


def features(pcm: torch.Tensor, cfg: dict, lowp: bool = False) -> Dict[str, torch.Tensor]:
    """[B, N] PCM -> the 19 keys, computed in blocks of ROWS clips."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(lowp)
    try:
        parts = [features_block(pcm[lo: lo + ROWS], cfg) for lo in range(0, pcm.shape[0], ROWS)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return {k: torch.cat([p[k] for p in parts]) for k in KEYS}


def _gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    inf = float("inf")
    for key in KEYS:
        g = got.get(key)
        if g is None or tuple(g.shape) != tuple(want[key].shape) or not bool(torch.isfinite(g).all()):
            return {name: inf for name in NAMES}
    g = {k: got[k].to(want[k].device, torch.float64) for k in KEYS}
    r = {k: want[k].to(torch.float64) for k in KEYS}

    def scale(k):
        return max(float(torch.amax(torch.abs(r[k]))), 1e-30)

    out = {f"{k}_gap": float(torch.amax(torch.abs(g[k] - r[k]))) / scale(k) for k in GAP_KEYS}
    for k in QUANTILE_KEYS:
        rel = (torch.abs(g[k] - r[k]) / scale(k)).flatten().float()
        out[f"{k}_q999_gap"] = float(torch.quantile(rel, QUANTILE))
    out["energy_gap"] = max(float(torch.amax(torch.abs(g[k] - r[k]))) / scale(k) for k in ENERGY_KEYS)
    out["decision_flips"] = max(
        float(torch.mean((torch.abs(g[k] - r[k]) > DECISION_RTOL * scale(k)).to(torch.float64)))
        for k in DECISION_KEYS)
    return out


NAMES = (tuple(f"{k}_gap" for k in GAP_KEYS) + tuple(f"{k}_q999_gap" for k in QUANTILE_KEYS)
         + ("energy_gap", "decision_flips"))


def compare(program: List[Dict[str, torch.Tensor]], expected: List[Dict[str, torch.Tensor]]
            ) -> Dict[str, float]:
    """The worst of each number over the sampled batches. A key that is
    missing, of another shape or not finite makes every number inf."""
    out = {name: 0.0 for name in NAMES}
    for got, want in zip(program, expected):
        for name, v in _gaps(got, want).items():
            out[name] = max(out[name], v)
    return out
