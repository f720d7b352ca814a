"""The run's random source: a `torch.Generator` on the run's device,
seeded from `--seed` (any whole number; it is masked to 63 bits)."""

from __future__ import annotations

import torch

SEED_MASK = (1 << 63) - 1


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed) & SEED_MASK)
    return g
