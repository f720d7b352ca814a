"""K4: min-interval onset thinning on Hopper — the wrapper, its plain
PyTorch version and its launch counter.

Counterpart of `sonido_sonar_tpu/ops/pallas_onsets.py`
(`thin_onsets_pallas`); the kernel is `csrc/onsets.cu`. Scanning each
row left to right, candidate i is kept iff i - last_kept >= min_frames,
with last_kept starting at -min_frames - 1 (ops/temporal.py:250-254).
For a CPU tensor the wrapper runs the plain version; for a CUDA tensor
it launches the kernel or raises — nothing falls back. Both give the
same bits: the recurrence makes integer decisions only.
`thin_onsets_model` replays the kernel's plan (tiles, candidate words,
the walk that seeks words and steps through each on its bitmask) in
numpy, so the CPU tests hold the plan itself.
"""

from __future__ import annotations

import numpy as np
import torch

from sonido_sonar_tpu_torch import _build

# frames per tile of the kernel (kTile in csrc/onsets.cu: 256 threads x 4
# 16-byte loads, less 32 so that a tile's chunks fit at any alignment)
TILE = 256 * 4 * 16 - 32


def thin_onsets_plain(cand: torch.Tensor, min_frames: int) -> torch.Tensor:
    """Plain version of K4: the recurrence over frames on [R] rows,
    [..., T] candidates -> [..., T] bool kept mask."""
    t = cand.shape[-1]
    flat = cand.reshape(-1, t) != 0
    last = torch.full((flat.shape[0],), -min_frames - 1, dtype=torch.int64, device=cand.device)
    kept = torch.empty_like(flat)
    for i in range(t):
        ok = flat[:, i] & (i - last >= min_frames)
        kept[:, i] = ok
        last = torch.where(ok, i, last)
    return kept.reshape(cand.shape)


_ALL = (1 << 64) - 1


def _seek(words, p: int):
    """(w, the candidate bits at or after frame p of the first 64-frame word
    w at or after p's that holds any), (len(words), 0) when none is left."""
    w = p >> 6
    if w >= len(words):
        return len(words), 0
    m = words[w] & (_ALL << (p & 63)) & _ALL
    while m == 0:
        w += 1
        if w >= len(words):
            return w, 0
        ahead = [j for j, x in enumerate(words[w:w + 32]) if x]
        if ahead:
            w += ahead[0]
            m = words[w]
        else:
            w += 31
    return w, m


def thin_onsets_model(cand, min_frames: int, tile: int = TILE) -> np.ndarray:
    """numpy replay of the kernel's plan, [..., T] -> [..., T] bool: per
    row, tiles of `tile` frames and their candidate bitmask in 64-frame
    words (bit j of word w is frame 64 w + j); the walk from p, the first
    frame the next onset may take (carried across tiles): seek the first
    word holding a candidate at or after p, step through it on its bitmask
    (below = m ^ (m - 1), the lowest bit and those under it: keep the
    lowest, then m &= ~below << (min_frames - 1)); up to 64 frames the
    part of that mask shifted out of the word masks the next word (sought
    on from the word after it when that leaves nothing), else the walk
    seeks from the last kept frame plus min_frames. min_frames is clamped
    to T as the C entry does."""
    cand = np.asarray(cand)
    t = cand.shape[-1]
    rows = cand.reshape(-1, t) != 0
    mf = min(int(min_frames), t)
    sh = min(mf, 64) - 1
    kept = np.zeros_like(rows)
    for r, row in enumerate(rows):
        nxt = 0
        for t0 in range(0, t, tile):
            n = min(tile, t - t0)
            nw = (n + 63) // 64
            bits = np.zeros(nw * 64, np.uint8)
            bits[:n] = row[t0:t0 + n]
            words = [int.from_bytes(np.packbits(b, bitorder="little").tobytes(), "little")
                     for b in bits.reshape(nw, 64)]
            out = [0] * nw
            p = min(nxt - t0, n) if nxt > t0 else 0
            w, m = _seek(words, p)
            lw = below = -1
            while m:
                ahead = words[w + 1] if w + 1 < nw else 0
                while m:
                    below = m ^ (m - 1)  # the lowest set bit and the bits under it
                    out[w] |= m & below
                    m &= (~below << sh) & _ALL
                lw = w
                if mf <= 64:  # the mask's part shifted out of the word masks the next
                    m = ahead & (((~below & _ALL) >> (64 - sh)) | (_ALL << sh) & _ALL if sh else _ALL)
                    if m:
                        w += 1
                    else:
                        w, m = _seek(words, 64 * (w + 2))
                else:
                    w, m = _seek(words, 64 * w + below.bit_length() - 1 + mf)
            if lw >= 0:  # else nxt stands: it may lie past this tile
                nxt = t0 + 64 * lw + below.bit_length() - 1 + mf
            flat = [(x >> j) & 1 for x in out for j in range(64)]
            kept[r, t0:t0 + n] = np.array(flat[:n], bool)
    return kept.reshape(cand.shape)


def thin_onsets_hopper(cand: torch.Tensor, min_frames: int) -> torch.Tensor:
    """[..., T] bool candidates -> [..., T] bool kept mask.

    CPU tensor: the plain version. CUDA tensor: the K4 kernel, which
    takes a contiguous bool tensor and min_frames >= 1; anything else
    raises.
    """
    if cand.device.type == "cpu":
        return thin_onsets_plain(cand, min_frames)
    if cand.device.type != "cuda":
        raise ValueError(f"no K4 kernel for device {cand.device}")
    if cand.dtype != torch.bool or not cand.is_contiguous() or cand.dim() < 1:
        raise ValueError(
            f"K4 needs a contiguous bool [..., T] tensor, got {cand.dtype}"
            f"{tuple(cand.shape)}"
        )
    if min_frames < 1:
        raise ValueError(f"K4 needs min_frames >= 1, got {min_frames}")
    t = cand.shape[-1]
    flat = cand.view(-1, t)
    if flat.shape[0] < 1 or t < 1:
        raise ValueError(f"K4 input {tuple(cand.shape)} is empty")
    kept = torch.empty_like(flat)
    with torch.cuda.device(cand.device):
        _build.call(
            "sonido_thin_onsets", flat.data_ptr(), kept.data_ptr(), flat.shape[0], t,
            int(min_frames), torch.cuda.current_stream(cand.device).cuda_stream,
        )
    thin_onsets_hopper.launches += 1
    return kept.view(cand.shape)


thin_onsets_hopper.launches = 0
