"""Where the port's entry points put their inputs.

The rule, as the JAX package places numpy input on its default device
(the accelerator): a tensor keeps its own device; anything else (numpy
arrays, lists) goes to `device`, which defaults to the card. Nothing
checks `torch.cuda.is_available()` to pick the CPU instead: on a
machine without a card a default call raises torch's own error, and a
caller who wants the CPU asks for it (`device="cpu"`).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"
Device = Union[str, torch.device]


def as_float32(x, device: Device = DEFAULT_DEVICE) -> torch.Tensor:
    """`x` as a float32 tensor: a tensor on its own device, anything else
    on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=torch.device(device))


def require_fp32_matmuls(t: torch.Tensor, what: str) -> None:
    """Raise on a CUDA input while TF32 matmuls are on: the matmuls of
    the feature paths feed logs and ratios, and the comparator's carry
    its cosines; TF32's ~1e-3 error is past their parity bounds, and the
    CPU tests cannot see it."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError(
            f"{what} needs true float32 matmuls: "
            "set torch.backends.cuda.matmul.allow_tf32 = False"
        )
