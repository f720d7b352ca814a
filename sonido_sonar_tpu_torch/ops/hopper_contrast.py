"""K9: sort-free spectral-contrast band selection on Hopper — the wrapper,
its plain PyTorch version and its launch counter.

Counterpart of `sonido_sonar_tpu/ops/pallas_contrast.py`
(`band_select_means_pallas`); the kernel is `csrc/contrast.cu`. Per frame
and band it gives the means of the top and bottom k = max(int(0.2 *
width), 1) powers (spectral_contrast.go:71-137), the two means
`ops/spectral.spectral_contrast` takes from its sorts. Like the JAX
package, nothing wires it into `spectral_contrast`: it is a public op,
held to its plain version on the card by `chip_smoke.py` and timed there
against the contrast sorts.

For a CPU tensor the wrapper runs the plain version (one `torch.sort`
per band); for a CUDA tensor it launches the kernel or raises — nothing
falls back.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from sonido_sonar_tpu_torch import _build


@functools.lru_cache(maxsize=16)
def _band_constants(
    edges: Tuple[int, ...], num_bins: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indicator [F, NB], indicator^T [NB, F], k [1, NB]) float32, as
    pallas_contrast.py:67-82 builds them: column b is 1 over the band's
    bins [lo, min(hi, F)); k = max(int(0.2 * width), 1), and 1 for a
    degenerate band (lo >= hi), whose column is all zero."""
    nb = len(edges) - 1
    m = np.zeros((num_bins, nb), np.float32)
    k = np.zeros((1, nb), np.float32)
    for b in range(nb):
        lo, hi = edges[b], min(edges[b + 1], num_bins)
        if lo >= hi:
            k[0, b] = 1.0
            continue
        m[lo:hi, b] = 1.0
        k[0, b] = max(int(0.2 * (hi - lo)), 1)
    return m, np.ascontiguousarray(m.T), k


@functools.lru_cache(maxsize=16)
def band_table(edges: Tuple[int, ...], num_bins: int) -> np.ndarray:
    """[NB, 3] int32 (lo, hi, k) per band from `_band_constants`: the run
    of the band's indicator column, and (0, 0, 1) for a degenerate band."""
    m, _, k = _band_constants(edges, num_bins)
    rows = []
    for b in range(m.shape[1]):
        nz = np.flatnonzero(m[:, b])
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        rows.append((lo, hi, int(k[0, b])))
    return np.array(rows, dtype=np.int32).reshape(-1, 3)


@functools.lru_cache(maxsize=16)
def _band_table_on(edges: Tuple[int, ...], num_bins: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(band_table(edges, num_bins)).to(device)


def band_select_means_plain(
    magnitude: torch.Tensor, edges: Tuple[int, ...]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K9: per band, sort the power; peak = mean of the
    top k, valley = mean of the bottom k; 0 for a degenerate band."""
    m = magnitude.to(torch.float32)
    power = m * m
    peaks, valleys = [], []
    for lo, hi, k in band_table(tuple(edges), magnitude.shape[-1]).tolist():
        if lo >= hi:
            zero = power.new_zeros(power.shape[:-1])
            peaks.append(zero)
            valleys.append(zero)
            continue
        ordered = torch.sort(power[..., lo:hi], dim=-1).values
        valleys.append(torch.mean(ordered[..., :k], dim=-1))
        peaks.append(torch.mean(ordered[..., hi - lo - k:], dim=-1))
    return torch.stack(peaks, dim=-1), torch.stack(valleys, dim=-1)


def band_select_means_hopper(
    magnitude: torch.Tensor, edges: Tuple[int, ...]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """magnitude [..., T, F] -> (peak, valley) [..., T, NB], NB =
    len(edges) - 1: the means of the top and bottom k powers of each band.

    CPU tensor: the plain version. CUDA tensor: the K9 kernel, which takes
    float32 contiguous magnitudes; anything else raises.
    """
    edges = tuple(int(e) for e in edges)
    if magnitude.device.type == "cpu":
        return band_select_means_plain(magnitude, edges)
    if magnitude.device.type != "cuda":
        raise ValueError(f"no K9 kernel for device {magnitude.device}")
    if magnitude.dtype != torch.float32 or not magnitude.is_contiguous() or magnitude.dim() < 1:
        raise ValueError("K9 needs float32 contiguous magnitudes [..., F]")
    f_bins = magnitude.shape[-1]
    nb = len(edges) - 1
    if nb < 1 or f_bins < 1:
        raise ValueError(f"K9 needs at least one band over at least one bin, got edges {edges}")
    frames = magnitude.numel() // f_bins
    dev = magnitude.device
    bands = _band_table_on(edges, f_bins, dev)
    out = torch.empty((2, frames, nb), dtype=torch.float32, device=dev)
    if frames:
        with torch.cuda.device(dev):
            _build.call(
                "sonido_contrast_band_means", magnitude.data_ptr(), bands.data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), frames, f_bins, nb,
                torch.cuda.current_stream(dev).cuda_stream,
            )
        band_select_means_hopper.launches += 1
    lead = magnitude.shape[:-1]
    return out[0].view(lead + (nb,)), out[1].view(lead + (nb,))


band_select_means_hopper.launches = 0
