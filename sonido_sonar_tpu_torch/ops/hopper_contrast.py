"""K9: sort-free spectral-contrast band selection on Hopper — the wrapper,
its plain PyTorch version and its launch counter.

Counterpart of `sonido_sonar_tpu/ops/pallas_contrast.py`
(`band_select_means_pallas`); the kernel is `csrc/contrast.cu`. Per frame
and band it gives the means of the top and bottom k = max(int(0.2 *
width), 1) powers (spectral_contrast.go:71-137), the two means
`ops/spectral.spectral_contrast` floors and turns into dB: every caller
of `spectral_contrast` takes its band means from this wrapper (where the
JAX package sorts). `tests/test_torch_card_kernels.py` holds the kernel
to its plain version on the card; `tools/time_kernels.py` times it there
against the sorts.

For a CPU tensor the wrapper runs the plain version (one `torch.sort`
per band); for a CUDA tensor it launches the kernel or raises — nothing
falls back. The kernel takes its lane plan (`band_plan`: each band's
keys in registers of a group of lanes, all selections searched in one
chain of rounds) where the band table fits a warp, and its general form
(keys in shared memory, band by band) elsewhere; `band_means_model`
replays the lane plan in numpy.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from sonido_sonar_tpu_torch import _build


@functools.lru_cache(maxsize=16)
def _band_constants(
    edges: Tuple[int, ...], num_bins: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indicator [F, NB], indicator^T [NB, F], k [1, NB]) float32, as
    pallas_contrast.py:67-82 builds them: column b is 1 over the band's
    bins [lo, min(hi, F)); k = max(int(0.2 * width), 1), and 1 for a
    degenerate band (lo >= hi), whose column is all zero."""
    nb = len(edges) - 1
    m = np.zeros((num_bins, nb), np.float32)
    k = np.zeros((1, nb), np.float32)
    for b in range(nb):
        lo, hi = edges[b], min(edges[b + 1], num_bins)
        if lo >= hi:
            k[0, b] = 1.0
            continue
        m[lo:hi, b] = 1.0
        k[0, b] = max(int(0.2 * (hi - lo)), 1)
    return m, np.ascontiguousarray(m.T), k


@functools.lru_cache(maxsize=16)
def band_table(edges: Tuple[int, ...], num_bins: int) -> np.ndarray:
    """[NB, 3] int32 (lo, hi, k) per band from `_band_constants`: the run
    of the band's indicator column, and (0, 0, 1) for a degenerate band."""
    m, _, k = _band_constants(edges, num_bins)
    rows = []
    for b in range(m.shape[1]):
        nz = np.flatnonzero(m[:, b])
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        rows.append((lo, hi, int(k[0, b])))
    return np.array(rows, dtype=np.int32).reshape(-1, 3)


@functools.lru_cache(maxsize=16)
def band_plan(edges: Tuple[int, ...], num_bins: int) -> Tuple[np.ndarray, int, int]:
    """K9's lane plan: (lanes [32, 4] int32, keys K, largest group).

    One warp takes one frame. Each band of `band_table` gets an aligned
    group of g lanes, g a power of two: all bands start at one lane, and
    while it fits in 32 lanes the band with the most keys per lane (the
    lowest such band on a tie) doubles its group. Lane j of band b's
    group holds the powers of bins lo + j, lo + j + g, ... in registers;
    its row is (b, lo + j, g, its key count); an idle lane's (-1, 0, 1,
    0). K is the most keys a lane holds; the kernel rounds it up to one
    of its instantiations, and takes its general form (the frame's keys
    in shared memory, band by band) past the largest (csrc/contrast.cu,
    kMaxLaneKeys). K is 0, and the kernel takes its general form, when
    there is no plan: more than 32 bands, or a band of 2^16 bins or more
    (its counts share a word in 16-bit halves)."""
    table = band_table(edges, num_bins)
    lanes = np.zeros((32, 4), np.int32)
    lanes[:, 0], lanes[:, 2] = -1, 1
    width = {b: int(hi - lo) for b, (lo, hi, _) in enumerate(table.tolist()) if lo < hi}
    if not width or len(table) > 32 or max(width.values()) >= 1 << 16:
        return lanes, 0, 1
    group = dict.fromkeys(width, 1)
    used = len(width)
    while True:
        worst = max(width, key=lambda b: (-(-width[b] // group[b]), -b))
        if used + group[worst] > 32:
            break
        used += group[worst]
        group[worst] *= 2
    lane = 0
    for b in sorted(width, key=lambda b: (-group[b], b)):  # descending sizes: aligned groups
        g = group[b]
        for j in range(g):
            lanes[lane] = (b, table[b, 0] + j, g, -(-(width[b] - j) // g))
            lane += 1
    return lanes, int(lanes[:, 3].max()), max(group.values())


def band_means_model(
    magnitude, edges: Tuple[int, ...]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """numpy replay of the kernel's plan on [..., F] float32 magnitudes:
    (peak, valley [..., NB] float32, the k-th largest and the k-th
    smallest power per band as uint32 keys [..., NB], rounds per frame).

    Per frame and lane, the keys of `band_plan` (p = m * m as its bit
    pattern: p >= 0, so the pattern orders like the value; 0 in unused
    slots, which no threshold >= 1 counts). Both selections search a rank
    among the largest: the k-th largest, and the k-th smallest as the
    (w - k + 1)-th largest. Each round, one bit lower for all twelve
    selections at once: count the keys >= prefix | half, top count in the
    low 16 bits and bottom count in the high 16 of one word, totalled over
    the band's group by an xor tree of shuffles; keep the bit where the
    count reaches the rank. The round loop ends, for the whole warp, when
    every selection's bucket [prefix, prefix + 2^bit) holds one key (or at
    bit 0, on ties): the k-th key is then the bucket's one key (or the
    prefix), the keys above it are those >= prefix + 2^bit, and the mean
    fills the tie as (sum above + (k - count above) * k-th) / k. Sums are
    taken in the kernel's order: each lane over its slots, then the xor
    tree. The replay takes K slots a lane, the plan's; the kernel's
    larger instantiation gives the same bits (its extra slots hold 0).
    Raises ValueError where `band_plan` gives no plan (the kernel's
    general form then runs)."""
    edges = tuple(int(e) for e in edges)
    mag = np.asarray(magnitude, np.float32)
    f_bins = mag.shape[-1]
    lanes, k_slots, gmax = band_plan(edges, f_bins)
    if k_slots == 0:
        raise ValueError(f"edges {edges} over {f_bins} bins have no lane plan")
    table = band_table(edges, f_bins)
    nb = len(table)
    frames = mag.reshape(-1, f_bins)
    n = frames.shape[0]
    keys_all = (frames * frames).view(np.uint32)
    band, first, g, count = (lanes[:, i] for i in range(4))
    slot = np.arange(k_slots)
    idx = np.clip(first[:, None] + g[:, None] * slot[None, :], 0, f_bins - 1)
    key = np.where(slot[None, :] < count[:, None], keys_all[:, idx], 0).astype(np.int64)  # [N, 32, K]
    live = band >= 0
    w = np.where(live, table[np.maximum(band, 0), 1] - table[np.maximum(band, 0), 0], 0).astype(np.int64)
    k = np.where(live, table[np.maximum(band, 0), 2], 1).astype(np.int64)
    r_top, r_bot = k, w - k + 1
    lane_ids = np.arange(32)

    def group_sum(v):
        o = gmax // 2
        while o >= 1:
            v = np.where(o < g, v + v[:, lane_ids ^ o], v)
            o //= 2
        return v

    pt = np.zeros((n, 32), np.int64)
    pb = np.zeros((n, 32), np.int64)
    gt, gb = np.broadcast_to(w, (n, 32)).copy(), np.broadcast_to(w, (n, 32)).copy()
    at, ab = np.zeros((n, 32), np.int64), np.zeros((n, 32), np.int64)
    bit = np.full(n, 31, np.int64)
    going = np.ones(n, bool)
    while going.any():
        half = (np.int64(1) << (bit - 1))[:, None]
        ct, cb = pt | half, pb | half
        c = (key >= ct[..., None]).sum(-1) | ((key >= cb[..., None]).sum(-1) << 16)
        c = group_sum(c) & 0xFFFFFFFF
        c_t, c_b = c & 0xFFFF, c >> 16
        up_t, up_b = c_t >= r_top, c_b >= r_bot
        sel = going[:, None]
        pt = np.where(sel & up_t, ct, pt)
        gt = np.where(sel & up_t, c_t, gt)
        at = np.where(sel & ~up_t, c_t, at)
        pb = np.where(sel & up_b, cb, pb)
        gb = np.where(sel & up_b, c_b, gb)
        ab = np.where(sel & ~up_b, c_b, ab)
        bit = np.where(going, bit - 1, bit)
        open_ = (live & ((gt - at > 1) | (gb - ab > 1))).any(-1)
        going &= open_ & (bit > 0)
    rounds = 31 - bit
    span = (np.int64(1) << bit)[:, None]
    ut, ub = pt + span, pb + span
    x = key.astype(np.uint32).view(np.float32)
    s_top = np.zeros((n, 32), np.float32)
    s_bot = np.zeros((n, 32), np.float32)
    for s in range(k_slots):  # each lane over its slots, in order
        s_top = s_top + np.where(key[..., s] >= ut, x[..., s], np.float32(0))
        s_bot = s_bot + np.where(key[..., s] < pb, x[..., s], np.float32(0))
    in_t = (key >= pt[..., None]) & (key < ut[..., None])
    in_b = (key >= pb[..., None]) & (key < ub[..., None])
    t_top = np.where(bit[:, None] == 0, pt, group_sum(np.where(in_t, key, 0).sum(-1)))
    t_bot = np.where(bit[:, None] == 0, pb, group_sum(np.where(in_b, key, 0).sum(-1)))
    s_top, s_bot = group_sum(s_top), group_sum(s_bot)
    top_f = t_top.astype(np.uint32).view(np.float32).astype(np.float64)
    bot_f = t_bot.astype(np.uint32).view(np.float32).astype(np.float64)
    kf = k.astype(np.float32)
    # the kernel's fused multiply-add: the product is exact in float64
    peak_l = (s_top + (k - at) * top_f).astype(np.float32) / kf
    valley_l = (s_bot + (k - (w - gb)) * bot_f).astype(np.float32) / kf
    head = live & (lane_ids % g == 0)
    out = [np.zeros((n, nb), dt) for dt in (np.float32, np.float32, np.uint32, np.uint32)]
    for dst, src in zip(out, (peak_l, valley_l, t_top, t_bot)):
        dst[:, band[head]] = src[:, head]
    lead = mag.shape[:-1]
    return (*(o.reshape(lead + (nb,)) for o in out), rounds.reshape(lead))


@functools.lru_cache(maxsize=16)
def _band_table_on(edges: Tuple[int, ...], num_bins: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(band_table(edges, num_bins)).to(device)


@functools.lru_cache(maxsize=16)
def _band_plan_on(edges: Tuple[int, ...], num_bins: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(band_plan(edges, num_bins)[0]).to(device)


def band_select_means_plain(
    magnitude: torch.Tensor, edges: Tuple[int, ...]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K9: per band, sort the power; peak = mean of the
    top k, valley = mean of the bottom k; 0 for a degenerate band."""
    m = magnitude.to(torch.float32)
    power = m * m
    peaks, valleys = [], []
    for lo, hi, k in band_table(tuple(edges), magnitude.shape[-1]).tolist():
        if lo >= hi:
            zero = power.new_zeros(power.shape[:-1])
            peaks.append(zero)
            valleys.append(zero)
            continue
        ordered = torch.sort(power[..., lo:hi], dim=-1).values
        valleys.append(torch.mean(ordered[..., :k], dim=-1))
        peaks.append(torch.mean(ordered[..., hi - lo - k:], dim=-1))
    return torch.stack(peaks, dim=-1), torch.stack(valleys, dim=-1)


def band_select_means_hopper(
    magnitude: torch.Tensor, edges: Tuple[int, ...]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """magnitude [..., T, F] -> (peak, valley) [..., T, NB], NB =
    len(edges) - 1: the means of the top and bottom k powers of each band.

    CPU tensor: the plain version. CUDA tensor: the K9 kernel, which takes
    float32 contiguous magnitudes; anything else raises.
    """
    edges = tuple(int(e) for e in edges)
    if magnitude.device.type == "cpu":
        return band_select_means_plain(magnitude, edges)
    if magnitude.device.type != "cuda":
        raise ValueError(f"no K9 kernel for device {magnitude.device}")
    if magnitude.dtype != torch.float32 or not magnitude.is_contiguous() or magnitude.dim() < 1:
        raise ValueError("K9 needs float32 contiguous magnitudes [..., F]")
    f_bins = magnitude.shape[-1]
    nb = len(edges) - 1
    if nb < 1 or f_bins < 1:
        raise ValueError(f"K9 needs at least one band over at least one bin, got edges {edges}")
    frames = magnitude.numel() // f_bins
    dev = magnitude.device
    bands = _band_table_on(edges, f_bins, dev)
    lanes = _band_plan_on(edges, f_bins, dev)
    _, keys, gmax = band_plan(edges, f_bins)
    out = torch.empty((2, frames, nb), dtype=torch.float32, device=dev)
    if frames:
        with torch.cuda.device(dev):
            _build.call(
                "sonido_contrast_band_means", magnitude.data_ptr(), bands.data_ptr(),
                lanes.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), frames, f_bins, nb,
                keys, gmax, torch.cuda.current_stream(dev).cuda_stream,
            )
        band_select_means_hopper.launches += 1
    lead = magnitude.shape[:-1]
    return out[0].view(lead + (nb,)), out[1].view(lead + (nb,))


band_select_means_hopper.launches = 0
