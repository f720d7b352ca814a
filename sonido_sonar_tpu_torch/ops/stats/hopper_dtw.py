"""The banded DTW fill on Hopper: the wrappers, their plain versions and
their launch counters.

Counterpart of the three fills of `sonido_sonar_tpu/ops/stats/pallas_dtw.py`
(`_fill_pairs_raw` :297, `fill_banded_pallas_batch` :439,
`fill_banded_pallas_scan_batch` :173). On the card the fill is two
kernels of `csrc/dtw.cu`, launched one after the other by one C entry,
`sonido_dtw_fill_banded`: the distance pre-pass writes every local
distance into the cost band, then the row recurrence overwrites the band
with D, row by row. Each also has a wrapper of its own, so that it can
be held to its plain version and timed alone. The plain versions are
`ops/stats/dtw._banded_local_distances`, `_fill_banded_rows` and
`_fill_banded` (the two composed). For a CPU tensor a wrapper runs its
plain version; for a CUDA tensor it launches its kernels or raises —
nothing falls back.
"""

from __future__ import annotations

import torch

from sonido_sonar_tpu_torch import _build
from sonido_sonar_tpu_torch.ops.stats.dtw import _banded_local_distances as local_distances_plain
from sonido_sonar_tpu_torch.ops.stats.dtw import _fill_banded as fill_banded_plain
from sonido_sonar_tpu_torch.ops.stats.dtw import _fill_banded_rows as fill_rows_plain


def _check_pairs(query: torch.Tensor, reference: torch.Tensor, band: int, n: int, m: int) -> None:
    """Raise KernelError unless the kernels take these inputs."""
    if query.device.type != "cuda" or reference.device != query.device:
        raise _build.KernelError(
            f"no DTW fill kernel for devices {query.device}, {reference.device}")
    if query.dim() != 3 or reference.dim() != 3 or query.shape[0] != reference.shape[0] \
            or tuple(query.shape[1:2]) != (n,) or tuple(reference.shape[1:2]) != (m,) \
            or query.shape[2] != reference.shape[2]:
        raise _build.KernelError(f"DTW fill needs [B, {n}, d] and [B, {m}, d], got "
                                 f"{tuple(query.shape)} and {tuple(reference.shape)}")
    if query.dtype != torch.float32 or reference.dtype != torch.float32 \
            or not (query.is_contiguous() and reference.is_contiguous()):
        raise _build.KernelError("DTW fill needs contiguous float32 inputs")
    b, d = query.shape[0], query.shape[2]
    if b < 1 or n < 1 or m < 1 or d < 1 or band < 0:
        raise _build.KernelError(
            f"DTW fill: empty input or negative band ({b}, {n}, {m}, {d}, {band})")


def _launch_pairs(entry: str, query: torch.Tensor, reference: torch.Tensor, band: int, n: int,
                  m: int) -> torch.Tensor:
    """The cost band [B, n+1, 2 band + 1] that C entry `entry` writes
    from the pairs."""
    _check_pairs(query, reference, band, n, m)
    b, d = query.shape[0], query.shape[2]
    cost = torch.empty((b, n + 1, 2 * band + 1), dtype=torch.float32, device=query.device)
    with torch.cuda.device(query.device):
        _build.call(
            entry, query.data_ptr(), reference.data_ptr(), cost.data_ptr(),
            b, n, m, d, band, torch.cuda.current_stream(query.device).cuda_stream,
        )
    return cost


def fill_banded_hopper(query: torch.Tensor, reference: torch.Tensor, band: int, n: int,
                       m: int) -> torch.Tensor:
    """[B, n, d] x [B, m, d] float32 -> cost band [B, n+1, 2 band + 1],
    cost_band[b, i, k] = cost[i, i - band + k] (BIG out of range).

    CPU tensors: the plain version. CUDA tensors: the distance pre-pass,
    then the row recurrence, two launches that count as one call. They
    take contiguous float32 inputs of these shapes on one device and any
    band: the recurrence keeps three rows of the band in shared memory
    (the previous D, the current row, the next row's distances in
    flight) up to band 9,672 (w = 19,345), and reads and writes the rows
    in the cost band itself above it. Anything else raises
    `_build.KernelError`, so the alignment handlers that degrade on data
    errors never take a kernel that could not run for one.
    """
    if query.device.type == "cpu":
        return fill_banded_plain(query, reference, band, n, m)
    cost = _launch_pairs("sonido_dtw_fill_banded", query, reference, band, n, m)
    fill_banded_hopper.launches += 1
    return cost


def local_distances_hopper(query: torch.Tensor, reference: torch.Tensor, band: int, n: int,
                           m: int) -> torch.Tensor:
    """The fill's distance pre-pass alone: [B, n, d] x [B, m, d] float32
    -> [B, n+1, 2 band + 1], row 0 the fill's first row, row i the local
    distances of row i (BIG out of range). Same inputs and refusals as
    `fill_banded_hopper`."""
    if query.device.type == "cpu":
        return local_distances_plain(query, reference, band, n, m)
    cost = _launch_pairs("sonido_dtw_local_distances", query, reference, band, n, m)
    local_distances_hopper.launches += 1
    return cost


def fill_rows_hopper(local: torch.Tensor, band: int, n: int, m: int) -> torch.Tensor:
    """The fill's row recurrence alone, in place: over a band of local
    distances [B, n+1, 2 band + 1] as `local_distances_hopper` gives it,
    overwrite rows 1..n with D; returns the band."""
    if local.device.type == "cpu":
        return fill_rows_plain(local, band, n, m)
    if local.device.type != "cuda" or local.dtype != torch.float32 \
            or not local.is_contiguous() or local.dim() != 3 \
            or tuple(local.shape[1:]) != (n + 1, 2 * band + 1) or local.shape[0] < 1 \
            or n < 1 or m < 1 or band < 0:
        raise _build.KernelError(
            f"DTW row recurrence needs a contiguous float32 CUDA band [B, {n + 1}, "
            f"{2 * band + 1}], got {tuple(local.shape)} {local.dtype} on {local.device}")
    with torch.cuda.device(local.device):
        _build.call("sonido_dtw_fill_rows", local.data_ptr(), local.shape[0], n, m, band,
                    torch.cuda.current_stream(local.device).cuda_stream)
    fill_rows_hopper.launches += 1
    return local


fill_banded_hopper.launches = 0
local_distances_hopper.launches = 0
fill_rows_hopper.launches = 0
