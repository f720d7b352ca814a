"""The banded DTW backtrack on Hopper: the wrapper, its plain version,
its launch counter and a numpy model of the kernel's walk.

Counterpart of `_walk_moves` in `sonido_sonar_tpu/ops/stats/pallas_backtrack.py`
(:150) with the move codes and the path reconstruction around it; the
kernel is `sonido_dtw_backtrack_banded` in `csrc/dtw.cu`, which reads the
band directly (no move codes). The plain version is
`ops/stats/dtw._backtrack_banded`. For a CPU tensor the wrapper runs the
plain version; for a CUDA tensor it launches the kernel or raises.
Both give the same path for the same band: the walk makes comparisons
only, and the costs along it are the same float32 differences.

The kernel's walker reads its neighbours from a ring of band rows that
bulk copies stage ahead of it in shared memory, and reads a neighbour
outside its row's staged window from the band itself (a miss: the same
value, later). `walk_model` replays that staging plan in numpy, so the
plan's reads and misses are held to the plain walk on the CPU;
`backtrack_banded_misses` launches the kernel and returns each pair's
miss count beside its outputs.
"""

from __future__ import annotations

import numpy as np
import torch

from sonido_sonar_tpu_torch import _build
from sonido_sonar_tpu_torch.ops.stats.dtw import _backtrack_banded as backtrack_banded_plain

RING_ROWS = 64   # csrc/dtw.cu kRingRows: rows staged ahead of the walker
RING_COLS = 256  # csrc/dtw.cu kRingCols: columns of a staged row


def _check(cost_band: torch.Tensor, band: int, n: int, m: int) -> None:
    """Raise KernelError unless the kernel takes this band."""
    if cost_band.device.type != "cuda":
        raise _build.KernelError(f"no DTW backtrack kernel for device {cost_band.device}")
    w = 2 * band + 1
    if cost_band.dim() != 3 or tuple(cost_band.shape[1:]) != (n + 1, w) \
            or cost_band.dtype != torch.float32 or not cost_band.is_contiguous():
        raise _build.KernelError(f"DTW backtrack needs a contiguous float32 [B, {n + 1}, {w}] "
                                 f"band, got {cost_band.dtype}{tuple(cost_band.shape)}")
    b = cost_band.shape[0]
    if b < 1 or n < 1 or m < 1 or band < 0:
        raise _build.KernelError(
            f"DTW backtrack: empty input or negative band ({b}, {n}, {m}, {band})")


def _launch(cost_band: torch.Tensor, band: int, n: int, m: int, misses: torch.Tensor | None):
    _check(cost_band, band, n, m)
    b, dev = cost_band.shape[0], cost_band.device
    qs = torch.empty((b, n + m), dtype=torch.int32, device=dev)
    rs = torch.empty((b, n + m), dtype=torch.int32, device=dev)
    cs = torch.empty((b, n + m), dtype=torch.float32, device=dev)
    length = torch.empty((b,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _build.call(
            "sonido_dtw_backtrack_banded", cost_band.data_ptr(), qs.data_ptr(), rs.data_ptr(),
            cs.data_ptr(), length.data_ptr(), b, n, m, band,
            torch.cuda.current_stream(dev).cuda_stream,
            None if misses is None else misses.data_ptr(),
        )
    return qs, rs, cs, length


def backtrack_banded_hopper(cost_band: torch.Tensor, band: int, n: int, m: int):
    """[B, n+1, 2 band + 1] float32 -> (qs, rs int32 [B, n+m], cs float32
    [B, n+m], length int32 [B]), start -> end, padded with the path's
    first point past `length`.

    CPU tensor: the plain version. CUDA tensor: the kernel, which takes
    a contiguous float32 band of that shape; anything else raises
    `_build.KernelError`.
    """
    if cost_band.device.type == "cpu":
        return backtrack_banded_plain(cost_band, band, n, m)
    out = _launch(cost_band, band, n, m, None)
    backtrack_banded_hopper.launches += 1
    return out


backtrack_banded_hopper.launches = 0


def backtrack_banded_misses(cost_band: torch.Tensor, band: int, n: int, m: int):
    """The kernel on a CUDA band, as `backtrack_banded_hopper` launches it,
    and each pair's miss count: ((qs, rs, cs, length), misses int32 [B]).
    For measuring the ring; it leaves the wrapper's launch count as it
    is, and takes only what the kernel takes."""
    misses = torch.zeros((cost_band.shape[0],), dtype=torch.int32, device=cost_band.device)
    return _launch(cost_band, band, n, m, misses), misses


def band_offset(cost_band: torch.Tensor, pair: int) -> int:
    """Elements from a 16-byte boundary to the start of pair `pair`'s band
    in `cost_band` (the `offset` of `walk_model` for that pair)."""
    n1, w = cost_band.shape[-2:]
    return (cost_band.data_ptr() // 4 + pair * n1 * w) % 4


def _window(kc: int, w: int, sh: int, rows: int, cols: int) -> tuple:
    """(lo, len) of the aligned window that csrc/dtw.cu stage_row stages
    around column kc of a row whose first element lies `sh` elements past
    a 16-byte boundary."""
    hi = kc + rows + 4
    lo = hi - cols
    if w <= cols:
        lo, hi = 0, w
    elif lo < 0:
        lo, hi = 0, cols
    elif hi > w:
        lo, hi = w - cols, w
    a = lo + ((4 - ((sh + lo) & 3)) & 3)
    e = max(hi - ((sh + hi) & 3), a)
    return a, e - a


def walk_model(band: np.ndarray, band_w: int, n: int, m: int, rows: int = RING_ROWS,
               cols: int = RING_COLS, offset: int = 0):
    """numpy model of the backtrack kernel's walk over one pair's band
    [n+1, 2 band_w + 1] float32, with a ring of `rows` slots of `cols`
    columns: (qs, rs int32 [n+m], cs float32 [n+m], length, misses).

    It replays the kernel's staging plan: rows n .. n-rows+1 are staged
    around the start column before the walk; when the walker leaves row i
    (an up or diag step, or a step up along j == 0) row i-rows is staged
    into the freed slot around the walker's new column, and row i-2 must
    then be in its slot. A staged row holds the 16-byte-aligned middle of
    its window (`offset`: the band's first element past a 16-byte
    boundary). A neighbour read inside its row's window comes from the
    ring; outside it, from the band (a miss, counted); outside the band it
    is +inf (no read). The comparisons, the border moves and cs (the
    chosen neighbour one step back minus this step's diag, in float32)
    are the kernel's.
    """
    band = np.asarray(band, np.float32)
    w = 2 * band_w + 1
    assert band.shape == (n + 1, w), band.shape
    slot_row = [-1] * rows
    slot_win = [(0, 0)] * rows

    def stage(r, kc):
        slot_row[r % rows] = r
        slot_win[r % rows] = _window(kc, w, (offset + r * w) % 4, rows, cols)

    misses = 0

    def read(r, kk):
        nonlocal misses
        if kk < 0 or kk >= w:
            return np.float32(np.inf)
        s = r % rows
        assert slot_row[s] == r, (r, slot_row[s])  # rows i and i-1 are always staged
        lo, ln = slot_win[s]
        if not lo <= kk < lo + ln:
            misses += 1
        return band[r, kk]

    i, j, k = n, m, m - n + band_w
    for r in range(n, max(n - rows, -1), -1):
        stage(r, k)
    c_ij = band[n, k] if 0 <= k < w else np.float32(np.inf)
    qs, rs, cs = [], [], []
    with np.errstate(invalid="ignore", over="ignore"):
        while i > 0 or j > 0:
            qs.append(i - 1)
            rs.append(j - 1)
            c = np.float32(0.0)
            if i == 0:
                j, k, down = j - 1, k - 1, False
            elif j == 0:
                k, down = k + 1, True
            else:
                up, diag, left = read(i - 1, k + 1), read(i - 1, k), read(i, k - 1)
                c = np.float32(c_ij - diag)
                if not abs(c) < np.float32(1e30):
                    c = np.float32(0.0)
                if diag < up and diag < left:
                    c_ij, j, down = diag, j - 1, True
                elif left < up:
                    c_ij, j, k, down = left, j - 1, k - 1, False
                else:
                    c_ij, k, down = up, k + 1, True
            cs.append(c)
            if down:
                if i - rows >= 0:
                    stage(i - rows, k)
                i -= 1
    length = len(qs)
    max_len = n + m
    out_q = np.full(max_len, qs[-1] if qs else 0, np.int32)
    out_r = np.full(max_len, rs[-1] if rs else 0, np.int32)
    out_c = np.zeros(max_len, np.float32)
    out_q[:length] = qs[::-1]
    out_r[:length] = rs[::-1]
    out_c[:length] = cs[::-1]
    return out_q, out_r, out_c, length, misses
