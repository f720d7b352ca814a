"""K4: min-interval onset thinning on Hopper — the wrapper, its plain
PyTorch version and its launch counter.

Counterpart of `sonido_sonar_tpu/ops/pallas_onsets.py`
(`thin_onsets_pallas`); the kernel is `csrc/onsets.cu`. Scanning each
row left to right, candidate i is kept iff i - last_kept >= min_frames,
with last_kept starting at -min_frames - 1 (ops/temporal.py:250-254).
For a CPU tensor the wrapper runs the plain version; for a CUDA tensor
it launches the kernel or raises — nothing falls back. Both give the
same bits: the recurrence makes integer decisions only.
"""

from __future__ import annotations

import torch

from sonido_sonar_tpu_torch import _build


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
