"""Per-device cache of the constant tables (windows, DFT bases, filter
banks, ...).

Every table is built once in numpy (float64 construction, float32
result, exactly as the JAX package builds it) and copied to each device
that asks for it. The cache key is (the numpy function, its arguments,
device).
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def device_table(
    make: Callable[..., np.ndarray], args: tuple, device: torch.device
) -> torch.Tensor:
    """`make(*args)` as a float32 tensor on `device`, built once."""
    arr = np.array(make(*args), dtype=np.float32)  # owned, writable copy
    return torch.from_numpy(arr).to(device)
