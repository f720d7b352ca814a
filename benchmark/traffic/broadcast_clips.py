"""Traffic kind "broadcast_clips": `distinct` batches of [batch, seconds x
rate] float32 clips of a mixed broadcast archive, made on the run's
device from the seed. Each batch holds `speech` speech-like clips,
`music` music-like clips, `crowd` crowd-noise clips and `beds` low-level
noise beds, in an order shuffled by the seed:

- speech: a glottal pulse train at f0 in [speech_f0_low, speech_f0_high)
  Hz (a slow intonation of +-10 % and a per-period jitter of
  `jitter`), through two formant resonators (F1 in [450, 800) Hz, F2 in
  [1100, 2300) Hz, bandwidths 60-120 Hz, as damped sinusoids convolved by
  FFT), with breath noise of `breath` relative level, under a syllable
  envelope at [syllable_low, syllable_high) Hz; speech runs of 1-3 s
  alternate with digital-silence pauses of [pause_low, pause_high) s,
  the clip opening on speech. (After the port's `io/synth.speech_like`.)
- music: three voices of [harmonics_low, harmonics_high] harmonics
  (amplitude 1/k) at f0 in [music_f0_low, music_f0_high) Hz, a new chord
  every [chord_low, chord_high) s, each chord decaying from its onset,
  plus light noise. (After `io/synth.music_like`.)
- crowd: white noise of sigma [crowd_low, crowd_high) under a random
  envelope that moves every `crowd_block_s` s.
- beds: white noise of sigma [bed_low, bed_high).

The same seed gives the same traffic on the same kind of device. Nothing
here imports the program.
"""

from __future__ import annotations

import math
from typing import List

import torch

from benchmark.core.seed import generator

KINDS = ("speech", "music", "crowd", "beds")


def _uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device, dtype=torch.float64)


def _runs(g, rows: int, n: int, sr: int, on_lo, on_hi, off_lo, off_hi, device) -> torch.Tensor:
    """[rows, n] bool: runs of `on` (first) alternating with runs of
    `off`, each run's length drawn from its range in seconds."""
    k = int(math.ceil(n / (sr * (on_lo + off_lo)))) + 1
    on = _uniform(g, (rows, k), on_lo, on_hi, device)
    off = _uniform(g, (rows, k), off_lo, off_hi, device)
    edges = torch.cumsum(torch.stack([on, off], dim=-1).reshape(rows, 2 * k), dim=-1) * sr
    t = torch.arange(n, device=device, dtype=torch.float64).expand(rows, n).contiguous()
    return torch.searchsorted(edges.contiguous(), t, right=True) % 2 == 0


def _blocks(values: torch.Tensor, n: int, block: int) -> torch.Tensor:
    """[rows, k] values held for `block` samples each, cut to n."""
    return torch.repeat_interleave(values, block, dim=-1)[:, :n]


def speech(t: dict, g, rows: int, n: int, sr: int, device) -> torch.Tensor:
    tt = torch.arange(n, device=device, dtype=torch.float64) / sr
    f0 = _uniform(g, (rows, 1), t["speech_f0_low"], t["speech_f0_high"], device)
    into = 1.0 + 0.1 * torch.sin(2 * math.pi * _uniform(g, (rows, 1), 0.2, 0.5, device) * tt
                                 + _uniform(g, (rows, 1), 0.0, 2 * math.pi, device))
    per = int(sr * 0.005)
    jit = _blocks(1.0 + t["jitter"] * torch.randn((rows, n // per + 1), generator=g, device=device,
                                                  dtype=torch.float64), n, per)
    phase = torch.cumsum(f0 * into * jit / sr, dim=-1)
    pulses = torch.zeros((rows, n), device=device, dtype=torch.float64)
    pulses[:, 1:] = (torch.floor(phase[:, 1:]) > torch.floor(phase[:, :-1])).to(torch.float64)
    del phase, jit, into
    # two formant resonators as damped sinusoids, convolved by FFT
    taps = 2048
    th = torch.arange(taps, device=device, dtype=torch.float64) / sr
    h = torch.zeros((rows, taps), device=device, dtype=torch.float64)
    for lo, hi, gain in ((450.0, 800.0, 1.0), (1500.0, 2600.0, 1.0)):
        f = _uniform(g, (rows, 1), lo, hi, device)
        bw = _uniform(g, (rows, 1), 60.0, 120.0, device)
        h += gain * torch.exp(-math.pi * bw * th) * torch.sin(2 * math.pi * f * th)
    pulses += t["breath"] * torch.randn((rows, n), generator=g, device=device, dtype=torch.float32)
    m = 1 << (n + taps).bit_length()
    x = torch.fft.irfft(torch.fft.rfft(pulses, m) * torch.fft.rfft(h, m), m)[:, :n]
    del pulses
    x /= torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-12)
    rate = _uniform(g, (rows, 1), t["syllable_low"], t["syllable_high"], device)
    env = 0.6 + 0.4 * torch.sin(2 * math.pi * rate * tt + _uniform(g, (rows, 1), 0.0, 2 * math.pi, device))
    talk = _runs(g, rows, n, sr, 1.0, 3.0, t["pause_low"], t["pause_high"], device)
    level = _uniform(g, (rows, 1), 0.3, 0.6, device)
    room = _uniform(g, (rows, 1), t["room_low"], t["room_high"], device)
    return x * env * talk * level + room * torch.randn((rows, n), generator=g, device=device,
                                                        dtype=torch.float32)


def music(t: dict, g, rows: int, n: int, sr: int, device) -> torch.Tensor:
    chord_s = _uniform(g, (rows, 1), t["chord_low"], t["chord_high"], device)
    k = int(math.ceil(n / (sr * t["chord_low"]))) + 1
    starts = torch.arange(k, device=device, dtype=torch.float64)[None, :] * chord_s * sr    # [rows, k]
    tt = torch.arange(n, device=device, dtype=torch.float64).expand(rows, n).contiguous()
    seg = torch.searchsorted(starts.contiguous(), tt, right=True) - 1                        # [rows, n]
    since = (tt - torch.gather(starts, 1, seg)) / sr
    decay = _uniform(g, (rows, k), 0.3, 1.0, device)
    x = torch.zeros((rows, n), device=device, dtype=torch.float64)
    n_harm = torch.randint(int(t["harmonics_low"]), int(t["harmonics_high"]) + 1, (rows, 1),
                           generator=g, device=device)
    for _ in range(3):
        f0 = _uniform(g, (rows, k), t["music_f0_low"], t["music_f0_high"], device)
        phase = 2 * math.pi * torch.cumsum(torch.gather(f0, 1, seg), dim=-1) / sr
        ph = _uniform(g, (rows, int(t["harmonics_high"])), 0.0, 2 * math.pi, device)
        for h in range(1, int(t["harmonics_high"]) + 1):
            on = (n_harm >= h).to(torch.float64)
            x += on * torch.sin(h * phase + ph[:, h - 1: h]) / (h * h)
        del phase
    x *= 0.6 + 0.4 * torch.exp(-since * torch.gather(decay, 1, seg))
    x /= torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-12)
    level = _uniform(g, (rows, 1), 0.3, 0.6, device)
    return x * level + 1e-3 * torch.randn((rows, n), generator=g, device=device, dtype=torch.float32)


def crowd(t: dict, g, rows: int, n: int, sr: int, device) -> torch.Tensor:
    block = max(int(t["crowd_block_s"] * sr), 1)
    env = _blocks(_uniform(g, (rows, n // block + 1), 0.0, 1.0, device), n, block)
    sigma = _uniform(g, (rows, 1), t["crowd_low"], t["crowd_high"], device)
    return sigma * env * torch.randn((rows, n), generator=g, device=device, dtype=torch.float32)


def beds(t: dict, g, rows: int, n: int, sr: int, device) -> torch.Tensor:
    sigma = _uniform(g, (rows, 1), t["bed_low"], t["bed_high"], device)
    return sigma * torch.randn((rows, n), generator=g, device=device, dtype=torch.float32)


MAKERS = {"speech": speech, "music": music, "crowd": crowd, "beds": beds}


def make_labelled(t: dict, seed: int, device, sample_rate: int):
    """(`distinct` float32 [batch, n] batches on `device`, the kind of
    each row of each batch)."""
    sr = int(sample_rate)
    b, n = int(t["batch"]), int(round(t["clip_seconds"] * sr))
    counts = {k: int(t[k]) for k in KINDS}
    if sum(counts.values()) != b:
        raise ValueError(f"the kinds' counts {counts} do not add up to the batch {b}")
    g = generator(seed, device)
    batches, labels = [], []
    for _ in range(int(t["distinct"])):
        x = torch.empty((b, n), dtype=torch.float32, device=device)
        order = torch.randperm(b, generator=g, device=device)
        kinds, lo = [""] * b, 0
        for kind in KINDS:
            rows = order[lo: lo + counts[kind]]
            lo += counts[kind]
            if len(rows):
                x[rows] = MAKERS[kind](t, g, len(rows), n, sr, device).to(torch.float32)
                for r in rows.tolist():
                    kinds[r] = kind
        batches.append(x.contiguous())
        labels.append(kinds)
    return batches, labels


def make(t: dict, seed: int, device, sample_rate: int) -> List[torch.Tensor]:
    """`distinct` float32 [batch, n] batches on `device`."""
    return make_labelled(t, seed, device, sample_rate)[0]
