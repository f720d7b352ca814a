"""Temporal/energy series (counterpart of the main-path part of
`sonido_sonar_tpu/ops/temporal.py`)."""

from __future__ import annotations

import torch


def energy_variance(energies: torch.Tensor) -> torch.Tensor:
    """Sample variance (N-1 denominator), [..., T] -> [...]
    (energy.go:97-119)."""
    t = energies.shape[-1]
    if t < 2:
        return energies.new_zeros(energies.shape[:-1])
    mean = torch.mean(energies, dim=-1, keepdim=True)
    return torch.sum((energies - mean) ** 2, dim=-1) / (t - 1)
