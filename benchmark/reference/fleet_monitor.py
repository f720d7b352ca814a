"""Plain reference of `FleetMonitor.measure_all(refine=True)`: what each
stream pair's measurement must be, from the two 60 s windows alone.

Plain PyTorch on the device, none of the program's code: a frozen copy
of the port's alignment math (short-time RMS energy, the NCC lag scan
and its peak metrics, the 0.7 gate, the banded DTW with its path scores,
the hybrid winner, the PCM verification by GCC-PHAT and the refinement;
alignment.go's policy as the port states it). Two parts are written
anew rather than copied:

- the energies frame the signal and take each frame's mean square
  (the port sums hop blocks);
- the banded DTW fill runs over anti-diagonals (each cell's
  D = l + min(up, left, diag) in one float32 add, no scan); the greedy
  walk's move out of every cell is worked out on the device in one pass
  and the walk follows the moves on the host. The port's own plain
  fill, a row loop of log-step scans, took 17.6 s at two pairs.

Only the pairs that fail the gate get a DTW, and only those that need
it get the PCM verification. `lowp=True` computes in bfloat16 (the
inputs, the energies and every correlation rounded to it): the control.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

EPS = 1e-10
MIN_STD = 1e-10
BIG = float(np.float32(3.4e38) / np.float32(4.0))
AMBIGUITY_ONSET, AMBIGUITY_SLOPE, AMBIGUITY_CAP = 0.75, 1.6, 0.4
VERIFY_TOP_K, VERIFY_FLOOR, VERIFY_MARGIN = 5, 0.02, 1.5
VERIFY_OVERLAP, VERIFY_CONF_CAP = 0.5, 0.9
PHAT_SEARCH_HOPS = 24
METHOD_NAMES = {0: "energy_correlation", 1: "hybrid_correlation", 2: "hybrid_dtw"}


def _lp(x: torch.Tensor, lowp: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype) if lowp else x


def _pow2(n: int) -> int:
    k = 1
    while k < n:
        k <<= 1
    return k


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, idx.to(torch.int64)[..., None])[..., 0]


def rms_energy(x: torch.Tensor, window: int, hop: int, rows: int = 8) -> torch.Tensor:
    """[B, N] -> [B, T]: sqrt(mean(frame^2)) over frames of `window` every `hop`."""
    out = []
    for lo in range(0, x.shape[0], rows):
        f = x[lo: lo + rows].unfold(-1, window, hop)
        out.append(torch.sqrt(torch.mean(f * f, dim=-1)))
    return torch.cat(out)


def _z(x: torch.Tensor) -> torch.Tensor:
    c = x - torch.mean(x, dim=-1, keepdim=True)
    std = torch.sqrt(torch.mean(c * c, dim=-1, keepdim=True))
    return torch.where(std < MIN_STD, c, c / torch.clamp_min(std, MIN_STD))


def _lag_window(full: torch.Tensor, size: int, max_lag: int) -> torch.Tensor:
    return torch.cat([full[..., size - max_lag:], full[..., : max_lag + 1]], dim=-1)


def ncc(q: torch.Tensor, r: torch.Tensor, max_lag: int) -> torch.Tensor:
    """NCC over the overlap at lags -max_lag..max_lag, [B, 2 max_lag + 1]."""
    n1, n2 = q.shape[-1], r.shape[-1]
    x1, x2 = _z(q), _z(r)
    size = _pow2(n1 + n2 - 1)
    num = _lag_window(torch.fft.irfft(torch.fft.rfft(x1, n=size) * torch.conj(torch.fft.rfft(x2, n=size)),
                                      n=size), size, max_lag)
    zero = x1.new_zeros(x1.shape[:-1] + (1,))
    c1 = torch.cat([zero, torch.cumsum(x1 * x1, dim=-1)], dim=-1)
    c2 = torch.cat([zero, torch.cumsum(x2 * x2, dim=-1)], dim=-1)
    lags = torch.arange(-max_lag, max_lag + 1, device=q.device)
    s1 = torch.where(lags >= 0, 0, -lags)
    e1 = torch.where(lags >= 0, torch.clamp_max(n2 - lags, n1), n1)
    length = torch.clamp_min(e1 - s1, 0)
    s2 = torch.where(lags >= 0, lags, 0)
    en1 = c1[..., torch.clamp(e1, 0, n1)] - c1[..., torch.clamp(s1, 0, n1)]
    en2 = c2[..., torch.clamp(s2 + length, 0, n2)] - c2[..., torch.clamp(s2, 0, n2)]
    den = torch.sqrt(torch.clamp_min(en1 * en2, 0.0))
    return torch.clamp(torch.where(den < EPS, 0.0, num / torch.clamp_min(den, EPS)), -1.0, 1.0)


def peak_metrics(c: torch.Tensor, max_lag: int):
    """(peak, peak_lag, peak_index, snr, sharpness, second, psl)."""
    n_lags = 2 * max_lag + 1
    idx = torch.arange(n_lags, device=c.device)
    a = torch.abs(c)
    pi = torch.argmax(a, dim=-1)
    peak = _take(c, pi)
    far5 = torch.abs(idx - pi[..., None]) > 5
    cnt = torch.sum(far5, dim=-1)
    noise = torch.sqrt(torch.sum(torch.where(far5, c * c, 0.0), dim=-1) / torch.clamp_min(cnt, 1))
    snr = torch.where(cnt == 0, 0.0, torch.where(
        noise < MIN_STD, float("inf"), 20.0 * torch.log10(torch.abs(peak) / torch.clamp_min(noise, MIN_STD))))
    cm = _take(c, torch.clamp(pi - 1, 0, n_lags - 1))
    cp = _take(c, torch.clamp(pi + 1, 0, n_lags - 1))
    sharp = torch.where((pi > 0) & (pi < n_lags - 1), -(cp - 2.0 * peak + cm), 0.0)
    second = _take(c, torch.argmax(torch.where(idx == pi[..., None], float("-inf"), a), dim=-1))
    side = torch.amax(torch.where(torch.abs(idx - pi[..., None]) > 10, a, 0.0), dim=-1)
    psl = torch.where(side < MIN_STD, float("inf"),
                      20.0 * torch.log10(torch.abs(peak) / torch.clamp_min(side, MIN_STD)))
    return peak, (pi - max_lag).to(torch.int32), pi, snr, sharp, second, psl


def corr_confidence(peak, sharp, psl, snr, second):
    pm = torch.abs(peak)
    peak_s = torch.where(pm >= 0.6, pm + (pm - 0.6) * 0.5, pm)
    ratio = torch.abs(second) / torch.clamp_min(pm, EPS)
    pen = torch.where((second != 0) & (pm > 0) & (ratio > 0.7), (ratio - 0.7) * 0.25, 0.0)
    exc = torch.where(pm >= 0.75, 0.12, torch.where(pm >= 0.6, 0.08, 0.0))
    conf = (0.55 * peak_s + 0.22 * torch.clamp_max(sharp * 8.0, 0.9)
            + 0.12 * torch.where((psl > 0) & torch.isfinite(psl), torch.clamp_max(psl / 15.0, 0.8), 0.0)
            + 0.06 * torch.where(snr > 0, torch.clamp_max(snr / 25.0, 0.7), 0.0)
            + 0.05 * 0.15 + exc - pen)
    return torch.where(pm < 0.1, 0.0, torch.clamp(conf, 0.0, 0.95))


def corr_quality(peak, sharp, psl, snr, lag, max_lag: int):
    pm = torch.abs(peak)
    neg = torch.abs(lag.to(torch.float32)) / float(max_lag)
    q = (0.50 * torch.where(pm >= 0.6, pm + (pm - 0.6) * 0.4, pm)
         + 0.25 * torch.clamp_max(sharp * 5.0, 0.85)
         + 0.15 * torch.where((psl > 0) & torch.isfinite(psl), torch.clamp_max(psl / 20.0, 0.7), 0.0)
         + 0.10 * torch.where(snr > 0, torch.clamp_max(snr / 30.0, 0.6), 0.0)
         + torch.where(pm >= 0.7, 0.10, torch.where(pm >= 0.55, 0.06, 0.0))
         - torch.where((lag < 0) & (neg > 0.90), (neg - 0.90) * 4.0, 0.0))
    return torch.where(pm < 0.08, 0.0, torch.clamp(q, 0.0, 1.0))


def xcorr(q, r, max_lag: int, hop: int, min_sep: int, top_k: int, lowp: bool) -> Dict[str, torch.Tensor]:
    c = _lp(ncc(q, r, max_lag), lowp)
    peak, lag, pi, snr, sharp, second, psl = peak_metrics(c, max_lag)
    n_lags = 2 * max_lag + 1
    y0 = _take(c, torch.clamp_min(pi - 1, 0))
    y1 = _take(c, pi)
    y2 = _take(c, torch.clamp_max(pi + 1, n_lags - 1))
    den = y0 - 2.0 * y1 + y2
    big = torch.abs(den) > 1e-12
    shift = 0.5 * (y0 - y2) / torch.where(big, den, 1.0)
    ok = (pi > 0) & (pi < n_lags - 1) & big & (torch.abs(shift) <= 1.0)
    offset = torch.round(-(lag.to(torch.float32) + torch.where(ok, shift, 0.0)) * hop).to(torch.int32)
    a = torch.abs(c)
    idx = torch.arange(n_lags, device=c.device)
    masked = torch.where(torch.abs(idx - pi[:, None]) <= min_sep, float("-inf"), a)
    second_sep = torch.amax(masked, dim=-1)
    amb = torch.clamp(torch.where(torch.isfinite(second_sep),
                                  second_sep / torch.clamp_min(_take(a, pi), EPS), 0.0), 0.0, 1.0)
    picks = [pi]
    for _ in range(top_k - 1):
        p = torch.argmax(masked, dim=-1)
        picks.append(p)
        masked = torch.where(torch.abs(idx - p[:, None]) <= min_sep, float("-inf"), masked)
    gate_conf = corr_confidence(peak, sharp, psl, snr, second)
    penalty = torch.clamp_max(AMBIGUITY_SLOPE * torch.clamp_min(amb - AMBIGUITY_ONSET, 0.0), AMBIGUITY_CAP)
    return {
        "offset_samples": offset, "similarity": torch.clamp(torch.abs(peak), 0.0, 1.0),
        "confidence": torch.clamp_min(gate_conf - penalty, 0.0), "confidence_gate": gate_conf,
        "quality": corr_quality(peak, sharp, psl, snr, lag, max_lag), "ambiguity": amb,
        "topk_lags": (torch.stack(picks, dim=-1) - max_lag).to(torch.int32),
    }


# -- banded DTW ---------------------------------------------------------

def dtw_fill(q: torch.Tensor, r: torch.Tensor, band: int, rows: int = 512) -> torch.Tensor:
    """[B, n] x [B, m] 1-D series -> D over the band, [B, n+1, 2 band + 3]:
    column k + 1 holds cost[i, i - band + k] (BIG outside the matrix),
    columns 0 and 2 band + 2 hold +inf (outside the band). Local distances
    by |q|^2 + |r|^2 - 2 q r (the port's and JAX's documented form), then
    D = min(l + min(up, left, diag), BIG) over anti-diagonals t = 2 i + k'."""
    b, n = q.shape
    m = r.shape[1]
    w = 2 * band + 1
    wp = w + 2
    dev = q.device
    cost = torch.full((b, n + 1, wp), BIG, dtype=torch.float32, device=dev)
    cost[:, :, 0] = float("inf")
    cost[:, :, wp - 1] = float("inf")
    cost[:, 0, band + 1] = 0.0
    k = torch.arange(w, device=dev)
    r_pad = torch.nn.functional.pad(r, (1, 1))  # r_pad[j] = r[j - 1] for j in [1, m]
    for lo in range(1, n + 1, rows):
        i = torch.arange(lo, min(lo + rows, n + 1), device=dev)
        j = i[:, None] - band + k[None, :]
        inside = (j >= 1) & (j <= m)
        rj = r_pad[:, torch.clamp(j, 0, m + 1)]
        qi = q[:, i - 1][:, :, None]
        d2 = (qi * qi + rj * rj) - 2.0 * (rj * qi)
        cost[:, lo: lo + i.numel(), 1: w + 1] = torch.where(inside, torch.sqrt(torch.clamp_min(d2, 0.0)), BIG)
    flat = cost.view(b, -1)
    bs = flat.stride(0)
    for t in range(3, 2 * n + w + 1):
        lo = max(1, -(-(t - w) // 2))
        hi = min(n, (t - 1) // 2)
        if hi < lo:
            continue
        cnt = hi - lo + 1
        base = lo * w + t

        def view(delta, base=base, cnt=cnt):
            return flat.as_strided((b, cnt), (bs, w), base + delta)

        cur = view(0)
        best = torch.minimum(torch.minimum(view(-wp + 1), view(-1)), view(-wp))
        cur.copy_(torch.clamp_max(cur + best, BIG))
    return cost


def walk_moves(cost: torch.Tensor) -> torch.Tensor:
    """The greedy walk's move out of every cell of rows 1..n, int8
    [B, n+1, 2 band + 3]: 2 diagonal when it beats up and left strictly,
    else 1 left when it beats up, else 0 up (dtw.go:165-217)."""
    up, left, diag = cost[:, :-1, 2:], cost[:, 1:, :-2], cost[:, :-1, 1:-1]
    moves = torch.zeros(cost.shape, dtype=torch.int8, device=cost.device)
    moves[:, 1:, 1:-1] = torch.where((diag < up) & (diag < left), 2,
                                     torch.where(left < up, 1, 0)).to(torch.int8)
    return moves


def dtw_walk(moves: np.ndarray, band: int, n: int, m: int):
    """The walk from (n, m) to (0, 0) over one pair's moves -> (i, j) of
    each cell in start-to-end order, both 1-based as the band's rows and
    columns count them."""
    ii, jj = [], []
    i, j = n, m
    at = moves.item
    while i > 0 or j > 0:
        ii.append(i)
        jj.append(j)
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            mv = at(i, j - i + band + 1)
            if mv == 2:
                i, j = i - 1, j - 1
            elif mv == 1:
                j -= 1
            else:
                i -= 1
    return np.asarray(ii[::-1], dtype=np.int64), np.asarray(jj[::-1], dtype=np.int64)


def _median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    v = torch.where(mask, values, float("inf"))
    s = torch.sort(v, dim=-1).values
    cnt = torch.sum(mask, dim=-1)
    med = (_take(s, torch.clamp_min(cnt - 1, 0) // 2) + _take(s, cnt // 2)) * 0.5
    return torch.where(cnt > 0, med, float("nan"))


def path_scores(qs, rs, cs, length, raw, n: int, m: int) -> Dict[str, torch.Tensor]:
    """The DTW path metrics of alignment.go:379-607 and the offset
    estimator, [B] pairs of paths padded to n + m."""
    dev = qs.device
    idx = torch.arange(qs.shape[-1], device=dev)
    ln = length.to(torch.int64)[:, None]
    valid = idx < ln
    lf = torch.clamp_min(length, 1).to(torch.float32)
    distance = raw / lf
    h = torch.where(ln // 4 >= 4, 2, 1)
    csm = torch.where(valid, cs, 0.0)
    csum = torch.cat([cs.new_zeros(cs.shape[:-1] + (1,)), torch.cumsum(csm, dim=-1)], dim=-1)
    lo = torch.clamp_min(idx - h, 0)
    hi = torch.minimum(ln - 1, idx + h)
    cnt = torch.clamp_min(hi - lo + 1, 1).to(torch.float32)
    sm = torch.where(valid, (torch.gather(csum, 1, torch.clamp_min(hi + 1, 0)) - torch.gather(csum, 1, lo)) / cnt, 0.0)
    sm_mean = torch.sum(sm, dim=-1) / lf
    sm_var = torch.sum(torch.where(valid, (sm - sm_mean[:, None]) ** 2, 0.0), dim=-1) / lf
    cv = torch.sqrt(sm_var) / torch.clamp_min(sm_mean, EPS)
    consistency = torch.where(length <= 1, 0.0, torch.where(sm_mean <= 1e-10, 1.0, 1.0 / (1.0 + cv)))
    dq = qs[:, 1:] - qs[:, :-1]
    dr = rs[:, 1:] - rs[:, :-1]
    total = torch.clamp_min(length - 1, 1).to(torch.float32)
    diag_ratio = torch.sum((dq > 0) & (dr > 0) & (idx[1:] < ln), dim=-1) / total
    diag_bias = torch.where(length <= 1, 1.0, 1.0 / (1.0 + torch.exp(-10.0 * (diag_ratio - 0.3))))
    changes = torch.sum(((dq[:, 1:] != dq[:, :-1]) | (dr[:, 1:] != dr[:, :-1])) & (idx[2:] < ln),
                        dim=-1).to(torch.float32)
    smooth = torch.where(length <= 2, 1.0, torch.clamp_min(1.0 - changes / total, 0.0))
    nd = distance / ((n + m) / 2.0)
    eff = torch.clamp_max(max(n, m) / lf, 1.0)
    mean_cost = torch.sum(csm, dim=-1) / lf
    quality = torch.clamp(0.3 * eff + 0.3 * diag_bias + 0.2 * smooth + 0.2 * consistency, 0.0, 1.0)
    similarity = torch.clamp(0.5 * (1.0 / (1.0 + nd)) + 0.3 * quality + 0.2 * (1.0 / (1.0 + mean_cost)), 0.0, 1.0)
    confidence = torch.clamp(0.4 * torch.exp(-nd * 2.0) + 0.25 * eff + 0.2 * consistency + 0.15 * diag_bias,
                             0.0, 1.0)
    confidence = torch.where(length == 0, 0.0, confidence)
    interior = valid & (qs > 0) & (rs > 0) & (qs < n - 1) & (rs < m - 1)
    disp = (rs - qs).to(torch.float32)
    med = _median(disp, interior)
    offset = torch.where(torch.any(interior, dim=-1), torch.trunc(torch.where(torch.isnan(med), 0.0, med)),
                         torch.floor(torch.sum(torch.where(valid, disp, 0.0), dim=-1) / lf)).to(torch.int32)
    within = torch.sum(interior & (torch.abs(disp - med[:, None]) <= 5.0), dim=-1)
    n_int = torch.sum(interior, dim=-1)
    oc = torch.where((length < 3) | (n_int == 0), 0.0, within / torch.clamp_min(n_int, 1))
    return {"offset_frames": offset, "confidence": confidence, "similarity": similarity,
            "quality": quality, "offset_consistency": oc.to(torch.float32)}


def dtw_align(q: torch.Tensor, r: torch.Tensor, band: int, hop: int) -> Dict[str, torch.Tensor]:
    n, m = q.shape[1], r.shape[1]
    dev = q.device
    cost = dtw_fill(q, r, band)
    raw = cost[:, n, m - n + band + 1].clone()
    moves = walk_moves(cost).cpu().numpy()
    length = n + m
    p_n = q.shape[0]
    qs = np.zeros((p_n, length), np.int64)
    rs = np.zeros((p_n, length), np.int64)
    lens = np.zeros(p_n, np.int64)
    for p in range(p_n):
        a, b = dtw_walk(moves[p], band, n, m)
        lens[p] = a.size
        qs[p], rs[p] = a[0], b[0]
        qs[p, : a.size], rs[p, : a.size] = a, b
    i_t, j_t = torch.from_numpy(qs).to(dev), torch.from_numpy(rs).to(dev)
    valid = torch.arange(length, device=dev)[None, :] < torch.from_numpy(lens).to(dev)[:, None]
    inner = valid & (i_t > 0) & (j_t > 0)
    ih, jh = torch.where(inner, i_t, 1), torch.where(inner, j_t, 1)
    kk = jh - ih + band + 1
    rows_p = torch.arange(p_n, device=dev)[:, None]
    cs = cost[rows_p, ih, kk] - cost[rows_p, ih - 1, kk]
    cs = torch.where(inner & (torch.abs(cs) < 1e30), cs, 0.0)
    del cost
    s = path_scores((i_t - 1).to(torch.int32), (j_t - 1).to(torch.int32), cs,
                    torch.from_numpy(lens).to(dev).to(torch.int32), raw, n, m)
    s["offset_samples"] = s.pop("offset_frames") * hop
    return s


# -- GCC-PHAT -------------------------------------------------------------

def _phat_cc(q, r, n_fft: int, max_lag: int, lowp: bool) -> torch.Tensor:
    cross = torch.fft.rfft(q, n=n_fft) * torch.conj(torch.fft.rfft(r, n=n_fft))
    mag = torch.abs(cross)
    phat = cross / torch.clamp_min(mag + 1e-3 * torch.mean(mag, dim=-1, keepdim=True), 1e-12)
    return _lp(_lag_window(torch.fft.irfft(phat, n=n_fft), n_fft, max_lag), lowp)


def _windows(x: torch.Tensor, starts: torch.Tensor, length: int) -> torch.Tensor:
    idx = starts.to(torch.int64)[..., None] + torch.arange(length, device=x.device)
    return torch.gather(x, 1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)


def phat_refine(q, r, offsets_s: torch.Tensor, sr: int, hop: int, max_off: int, lowp: bool):
    """GCC-PHAT around coarse offsets [B] or [B, K] (seconds) ->
    (refined seconds float32, peaks)."""
    n1, n2 = q.shape[-1], r.shape[-1]
    length = min(n1, n2) - max_off
    max_lag = max(PHAT_SEARCH_HOPS * hop, 8)
    n_fft = _pow2(length + max_lag)
    coarse = torch.clamp(torch.round(offsets_s.to(torch.float32) * sr).to(torch.int32), -max_off, max_off)
    qw = _windows(q, torch.clamp(-coarse, 0, n1 - length), length)
    rw = _windows(r, torch.clamp(coarse, 0, n2 - length), length)
    cc = _phat_cc(qw, rw, n_fft, max_lag, lowp)
    i = torch.argmax(cc, dim=-1)
    peaks = torch.gather(cc, -1, i[..., None])[..., 0]
    return (coarse - (i.to(torch.int32) - max_lag)).to(torch.float32) / float(sr), peaks


def phat_global(q, r, sr: int, max_lag_samples: int, lowp: bool):
    length = min(q.shape[-1], r.shape[-1])
    max_lag = min(max_lag_samples, length - 1)
    cc = _phat_cc(q[..., :length], r[..., :length], _pow2(length + max_lag), max_lag, lowp)
    i = torch.argmax(cc, dim=-1)
    peaks = torch.gather(cc, -1, i[..., None])[..., 0]
    return -(i.to(torch.int32) - max_lag).to(torch.float32) / float(sr), peaks


# -- the whole measurement -------------------------------------------------

def measure(src: torch.Tensor, cdn: torch.Tensor, cfg: dict, lowp: bool = False) -> Dict[str, np.ndarray]:
    """[B, N] source and CDN windows -> per pair latency_s (the refined
    offset), confidence, similarity and method, as measure_all gives them."""
    sr, win, hop = int(cfg["sample_rate"]), int(cfg["window_size"]), int(cfg["hop_size"])
    q, r = _lp(src.to(torch.float32), lowp), _lp(cdn.to(torch.float32), lowp)
    n = q.shape[-1]
    max_off = min(int(cfg["max_lag_seconds"] * sr) + 32 * hop, 3 * n // 4)
    qe, re_ = _lp(rms_energy(q, win, hop), lowp), _lp(rms_energy(r, win, hop), lowp)
    t1, t2 = qe.shape[-1], re_.shape[-1]
    max_lag = max(min(int(cfg["max_lag_seconds"] * sr) // hop, t1 - 1, t2 - 1), 0)
    min_sep = max(int(0.1 * sr / max(hop, 1)), 2)
    xc = xcorr(qe, re_, max_lag, hop, min_sep, VERIFY_TOP_K, lowp)
    off, conf, sim = xc["offset_samples"].clone(), xc["confidence"].clone(), xc["similarity"].clone()
    method = torch.zeros_like(off)
    need_dtw = ~(xc["confidence_gate"] > float(cfg["acceptance_gate"]))
    if bool(need_dtw.any()):
        band = min(max(int(cfg["dtw_band_min_frames"]), max_lag), max(t1, t2))
        band = max(band, abs(t1 - t2))
        rows = torch.nonzero(need_dtw)[:, 0]
        dt = dtw_align(qe[rows], re_[rows], band, hop)
        cc = xc["confidence"][rows]
        wins = dt["confidence"] * torch.sqrt(dt["offset_consistency"]) >= cc
        off[rows] = torch.where(wins, dt["offset_samples"], off[rows])
        conf[rows] = 0.6 * dt["confidence"] + 0.4 * cc
        sim[rows] = 0.7 * dt["similarity"] + 0.3 * xc["similarity"][rows]
        method[rows] = torch.where(wins, 2, 1).to(method.dtype)
    off_s = off.to(torch.float64) / float(sr)
    lag_f = -off.to(torch.float64) / hop
    ov = torch.clamp_min(torch.clamp_max(t2 - lag_f, t1) - torch.clamp_min(-lag_f, 0.0), 0.0)
    need = (xc["ambiguity"] > AMBIGUITY_ONSET) | (ov < VERIFY_OVERLAP * min(t1, t2))
    conf = conf.to(torch.float64)
    off = off.to(torch.int64)
    if bool(need.any()):
        rows = torch.nonzero(need)[:, 0]
        go, gp = phat_global(q[rows], r[rows], sr, int(cfg["max_lag_seconds"] * sr), lowp)
        go = torch.where(gp.to(torch.float64) >= VERIFY_FLOOR, go.to(torch.float64), off_s[rows])
        cand = torch.cat([-xc["topk_lags"][rows].to(torch.float64) * hop / sr, off_s[rows][:, None],
                          go[:, None]], dim=1)
        refined, peaks = phat_refine(q[rows], r[rows], cand.to(torch.float32), sr, hop, max_off, lowp)
        refined, peaks = refined.to(torch.float64), peaks.to(torch.float64)
        k = torch.argmax(peaks, dim=1)
        best_off, best_val = _take(refined, k), _take(peaks, k)
        rival = torch.amax(torch.where(torch.abs(refined - best_off[:, None]) > hop / float(sr), peaks, 0.0), dim=1)
        decisive = (best_val >= VERIFY_FLOOR) & (best_val / torch.clamp_min(rival, 1e-9) >= VERIFY_MARGIN)
        off[rows] = torch.round(best_off * sr).to(torch.int64)
        floor = torch.maximum(torch.maximum(conf[rows], xc["confidence_gate"][rows].to(torch.float64)),
                              torch.clamp_max(best_val, VERIFY_CONF_CAP))
        conf[rows] = torch.where(decisive, floor, conf[rows])
    off_s = off.to(torch.float64) / float(sr)
    latency = off_s.to(torch.float32)
    if cfg.get("refine", True):
        latency, _ = phat_refine(q, r, off_s.to(torch.float32), sr, hop, max_off, lowp)
    names = []
    for mth, ver in zip(method.tolist(), need.tolist()):
        names.append(METHOD_NAMES[int(mth)] + ("+verify" if ver else "")
                     + ("+phat" if cfg.get("refine", True) else ""))
    return {"latency_s": latency.double().cpu().numpy(), "confidence": conf.double().cpu().numpy(),
            "similarity": sim.double().cpu().numpy(), "method": names}


def compare(program: List[dict], expected: List[dict], sample_rate: int,
            min_confidence: float) -> Dict[str, float]:
    """Worst gaps over the sampled calls: each call's program rows
    (dicts of latency_s, confidence, similarity, method, time_s) against
    the expected arrays (with time_s).

    Latencies are compared where the reference's confidence reaches
    `min_confidence` (AlignmentConfig's, the level at which the monitor
    takes a measurement as a latency), exactly. Below it a pair's
    candidates are undecided: its latency is a pick among noise peaks
    that a last-bit change of the energies moves (PERF.md); its
    confidence, similarity and method are still compared."""
    lat = conf = sim = t_gap = 0.0
    methods = 0
    for got, want in zip(program, expected):
        for i, row in enumerate(got["rows"]):
            if row is None:
                lat = conf = sim = float("inf")
                continue
            if float(want["confidence"][i]) >= min_confidence:
                lat = max(lat, abs(row["latency_s"] - float(want["latency_s"][i])) * sample_rate)
            conf = max(conf, abs(row["confidence"] - float(want["confidence"][i])))
            sim = max(sim, abs(row["similarity"] - float(want["similarity"][i])))
            methods += int(row["method"] != want["method"][i])
            t_gap = max(t_gap, abs(row["time_s"] - want["time_s"]))
    return {"confident_latency_max_abs_samples": lat, "confidence_max_abs": conf, "similarity_max_abs": sim,
            "method_mismatches": float(methods), "stream_time_max_abs_s": t_gap}
