"""The banded DTW fill on Hopper: the wrapper, its plain version and its
launch counter.

Counterpart of the three fills of `sonido_sonar_tpu/ops/stats/pallas_dtw.py`
(`_fill_pairs_raw` :297, `fill_banded_pallas_batch` :439,
`fill_banded_pallas_scan_batch` :173), one kernel here:
`sonido_dtw_fill_banded` in `csrc/dtw.cu`. The plain version is
`ops/stats/dtw._fill_banded`. For a CPU tensor the wrapper runs the
plain version; for a CUDA tensor it launches the kernel or raises —
nothing falls back.
"""

from __future__ import annotations

import torch

from sonido_sonar_tpu_torch import _build
from sonido_sonar_tpu_torch.ops.stats.dtw import _fill_banded as fill_banded_plain


def fill_banded_hopper(query: torch.Tensor, reference: torch.Tensor, band: int, n: int,
                       m: int) -> torch.Tensor:
    """[B, n, d] x [B, m, d] float32 -> cost band [B, n+1, 2 band + 1],
    cost_band[b, i, k] = cost[i, i - band + k] (BIG out of range).

    CPU tensors: the plain version. CUDA tensors: the kernel, which takes
    contiguous float32 inputs of these shapes on one device and any band
    (two rows of the band sit in shared memory up to band ~14,500 at
    d = 12, in the cost band above it). Anything else raises
    `_build.KernelError`, so the alignment handlers that degrade on data
    errors never take a kernel that could not run for one.
    """
    if query.device.type == "cpu":
        return fill_banded_plain(query, reference, band, n, m)
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
    cost = torch.empty((b, n + 1, 2 * band + 1), dtype=torch.float32, device=query.device)
    with torch.cuda.device(query.device):
        _build.call(
            "sonido_dtw_fill_banded", query.data_ptr(), reference.data_ptr(), cost.data_ptr(),
            b, n, m, d, band, torch.cuda.current_stream(query.device).cuda_stream,
        )
    fill_banded_hopper.launches += 1
    return cost


fill_banded_hopper.launches = 0
