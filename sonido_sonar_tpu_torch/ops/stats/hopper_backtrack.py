"""The banded DTW backtrack on Hopper: the wrapper, its plain version
and its launch counter.

Counterpart of `_walk_moves` in `sonido_sonar_tpu/ops/stats/pallas_backtrack.py`
(:150) with the move codes and the path reconstruction around it; the
kernel is `sonido_dtw_backtrack_banded` in `csrc/dtw.cu`, which reads the
band directly (no move codes). The plain version is
`ops/stats/dtw._backtrack_banded`. For a CPU tensor the wrapper runs the
plain version; for a CUDA tensor it launches the kernel or raises.
Both give the same path for the same band: the walk makes comparisons
only, and the costs along it are the same float32 differences.
"""

from __future__ import annotations

import torch

from sonido_sonar_tpu_torch import _build
from sonido_sonar_tpu_torch.ops.stats.dtw import _backtrack_banded as backtrack_banded_plain


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
    dev = cost_band.device
    qs = torch.empty((b, n + m), dtype=torch.int32, device=dev)
    rs = torch.empty((b, n + m), dtype=torch.int32, device=dev)
    cs = torch.empty((b, n + m), dtype=torch.float32, device=dev)
    length = torch.empty((b,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _build.call(
            "sonido_dtw_backtrack_banded", cost_band.data_ptr(), qs.data_ptr(), rs.data_ptr(),
            cs.data_ptr(), length.data_ptr(), b, n, m, band,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    backtrack_banded_hopper.launches += 1
    return qs, rs, cs, length


backtrack_banded_hopper.launches = 0
