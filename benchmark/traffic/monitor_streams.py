"""Traffic kind "monitor_streams": per stream pair, a source ring of
`ring_seconds` of white noise (sigma `sigma`) under a piecewise-constant
envelope of `segments_per_second` segments drawn from [env_low,
env_high), and a CDN ring that is the source delayed (circularly) by a
lag drawn from [lag_low_s, lag_high_s] times `gain`; the rows in
`unrelated` get a CDN ring of their own of the same kind. The rings come
as chunks of `advance_seconds`, [chunks, streams, samples], made on the
run's device from the seed in a few large calls. (A copy of the port's
`utils/parity.alignment_streams`, the JAX bench's monitor streams.)

The same seed gives the same traffic on the same kind of device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from benchmark.core.seed import generator


@dataclass
class MonitorStreams:
    source: torch.Tensor       # [chunks, streams, advance samples]
    cdn: torch.Tensor          # [chunks, streams, advance samples]
    lags_samples: np.ndarray   # [streams], int; 0 for an unrelated row
    unrelated: List[int]
    sample_rate: int
    advance: int               # samples per chunk

    @property
    def chunks(self) -> int:
        return int(self.source.shape[0])


def _noise_rows(n_rows: int, n: int, sr: int, t: dict, g: torch.Generator, device) -> torch.Tensor:
    seg_len = sr // int(t["segments_per_second"])
    segs = -(-n // seg_len)
    env = torch.rand((n_rows, segs), generator=g, device=device)
    env = t["env_low"] + (t["env_high"] - t["env_low"]) * env
    env = torch.repeat_interleave(env, seg_len, dim=1)[:, :n]
    x = torch.randn((n_rows, n), generator=g, device=device)
    return (x * float(t["sigma"])) * env


def make(t: dict, seed: int, device, sample_rate: int) -> MonitorStreams:
    sr = int(sample_rate)
    n_streams = int(t["streams"])
    advance = int(round(t["advance_seconds"] * sr))
    chunks = int(round(t["ring_seconds"] / t["advance_seconds"]))
    n = chunks * advance
    g = generator(seed, device)
    src = _noise_rows(n_streams, n, sr, t, g, device)
    lags = torch.randint(int(round(t["lag_low_s"] * sr)), int(round(t["lag_high_s"] * sr)) + 1,
                         (n_streams,), generator=g, device=device).cpu().numpy()
    cdn = torch.empty_like(src)
    for i in range(n_streams):
        cdn[i] = torch.roll(src[i], int(lags[i])) * float(t["gain"])
    unrelated = [int(i) for i in t.get("unrelated", [])]
    if unrelated:
        cdn[unrelated] = _noise_rows(len(unrelated), n, sr, t, g, device)
        lags[unrelated] = 0
    shape = (n_streams, chunks, advance)
    src = src.view(shape).transpose(0, 1).contiguous()
    cdn = cdn.view(shape).transpose(0, 1).contiguous()
    return MonitorStreams(src, cdn, lags.astype(np.int64), unrelated, sr, advance)
