"""Traffic kind "pcm_clips": `distinct` batches of [batch, seconds x
rate] float32 clips: 12-harmonic tones (f0 in [f0_low, f0_high) Hz,
amplitude 0.5/k, random phases) plus light noise (sigma in [noise_low,
noise_high)), every `noise_every`-th row white noise of sigma
`noise_sigma`, made on the run's device from the seed. (A copy of the
port's `utils/parity.synth_pcm`.)

The same seed gives the same traffic on the same kind of device.
"""

from __future__ import annotations

import math
from typing import List

import torch

from benchmark.core.seed import generator


def make(t: dict, seed: int, device, sample_rate: int) -> List[torch.Tensor]:
    """`distinct` float32 [batch, n] batches on `device`."""
    sr = int(sample_rate)
    b, n = int(t["batch"]), int(round(t["clip_seconds"] * sr))
    harmonics = int(t["harmonics"])
    g = generator(seed, device)
    tt = torch.arange(n, dtype=torch.float64, device=device) / sr
    out = []
    for _ in range(int(t["distinct"])):
        u = torch.rand((b, 2 + harmonics), generator=g, device=device, dtype=torch.float64)
        f0 = t["f0_low"] + (t["f0_high"] - t["f0_low"]) * u[:, :1]
        sigma = t["noise_low"] + (t["noise_high"] - t["noise_low"]) * u[:, 1:2]
        phases = 2 * math.pi * u[:, 2:]
        noise_row = (torch.arange(b, device=device) % int(t["noise_every"])) == int(t["noise_every"]) - 1
        sigma = torch.where(noise_row[:, None], float(t["noise_sigma"]), sigma)
        x = torch.zeros((b, n), dtype=torch.float64, device=device)
        for k in range(1, harmonics + 1):
            x += (0.5 / k) * torch.sin(2 * math.pi * k * f0 * tt + phases[:, k - 1: k])
        x *= (~noise_row).to(torch.float64)[:, None]
        x += sigma * torch.randn((b, n), generator=g, device=device, dtype=torch.float32)
        out.append(x.to(torch.float32).contiguous())
        del x
    return out
