"""Traffic kind "music_catalog": `distinct` batches of [batch, seconds x
rate] float32 tracks of a tagged music library, made on the run's device
from the seed. Each batch holds `rhythmic` tracks with a drum part and
`beatless` tracks without one, in an order shuffled by the seed:

- rhythmic: a drum part at a tempo drawn in [tempo_low, tempo_high) BPM,
  4 beats a bar: a kick (a sine at [kick_low, kick_high) Hz decaying
  over `kick_s`) on beats 1 and 3, a snare (a noise burst decaying over
  `snare_s`) on 2 and 4, and a closed hat (a first-differenced, so
  high-passed, noise burst of `hat_s`) on every eighth. Under it three
  voices of [harmonics_low, harmonics_high] harmonics at amplitude 1/k,
  f0 in [f0_low, f0_high) Hz, with a new chord every 2 or 4 bars.
- beatless: the three voices only, a new chord every [chord_low,
  chord_high) s.

Each chord's voices decay from its onset to 60 % of their level. Each
track is scaled to a peak of [peak_db_low, peak_db_high) dBFS and laid
over white noise at [floor_db_low, floor_db_high) dBFS (a noise floor
near -70 dBFS). The hits of one instrument never overlap (the shortest
spacing, an eighth at the fastest tempo, outlasts the longest hit), so
they are written with one scatter each and the traffic is the same for
the same seed on the same kind of device. Nothing here imports the
program.
"""

from __future__ import annotations

import math
from typing import List

import torch

from benchmark.core.seed import generator

KINDS = ("rhythmic", "beatless")


def _uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device, dtype=torch.float64)


def _db(v: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, v / 20.0)


def voices(t: dict, g, chord_s: torch.Tensor, n: int, sr: int, device) -> torch.Tensor:
    """[rows, n] float64: three voices of harmonics at 1/k over chords
    that change every chord_s [rows, 1] seconds, each chord decaying from
    its onset; peak-normalized."""
    rows = chord_s.shape[0]
    k = int(math.ceil(n / (sr * float(chord_s.min())))) + 1
    starts = torch.arange(k, device=device, dtype=torch.float64)[None, :] * chord_s * sr     # [rows, k]
    tt = torch.arange(n, device=device, dtype=torch.float64).expand(rows, n).contiguous()
    seg = torch.searchsorted(starts.contiguous(), tt, right=True) - 1                          # [rows, n]
    since = (tt - torch.gather(starts, 1, seg)) / sr
    del tt
    decay = _uniform(g, (rows, k), 0.3, 1.0, device)
    n_harm = torch.randint(int(t["harmonics_low"]), int(t["harmonics_high"]) + 1, (rows, 1),
                           generator=g, device=device)
    x = torch.zeros((rows, n), device=device, dtype=torch.float64)
    for _ in range(3):
        f0 = _uniform(g, (rows, k), t["f0_low"], t["f0_high"], device)
        phase = 2 * math.pi * torch.cumsum(torch.gather(f0, 1, seg), dim=-1) / sr
        ph = _uniform(g, (rows, int(t["harmonics_high"])), 0.0, 2 * math.pi, device)
        for h in range(1, int(t["harmonics_high"]) + 1):
            on = (n_harm >= h).to(torch.float64)
            x += on * torch.sin(h * phase + ph[:, h - 1: h]) / h
        del phase
    x *= 0.6 + 0.4 * torch.exp(-since * torch.gather(decay, 1, seg))
    return x / torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-12)


def _hits(out: torch.Tensor, at: torch.Tensor, wave: torch.Tensor) -> None:
    """Add wave [rows, hits, L] at sample offsets at [rows, hits] (int64;
    a hit past the end is cut) into out [rows, n], one scatter."""
    rows, n = out.shape
    length = wave.shape[-1]
    idx = at[..., None] + torch.arange(length, device=out.device)                 # [rows, hits, L]
    keep = idx < n
    flat = (idx + n * torch.arange(rows, device=out.device)[:, None, None]).clamp_max(rows * n - 1)
    out.view(-1).scatter_add_(0, flat[keep], wave[keep])


def drums(t: dict, g, period_s: torch.Tensor, n: int, sr: int, device) -> torch.Tensor:
    """[rows, n] float64: kick on beats 1 and 3, snare on 2 and 4, a
    closed hat on every eighth, at beat period period_s [rows, 1];
    peak-normalized."""
    rows = period_s.shape[0]
    out = torch.zeros((rows, n), device=device, dtype=torch.float64)
    beats = int(math.ceil(n / (sr * float(period_s.min())))) + 1
    beat_at = torch.round(torch.arange(beats, device=device, dtype=torch.float64)[None, :] * period_s * sr)

    kick_len = int(t["kick_s"] * sr)
    tk = torch.arange(kick_len, device=device, dtype=torch.float64) / sr
    f_kick = _uniform(g, (rows, 1, 1), t["kick_low"], t["kick_high"], device)
    kick = torch.sin(2 * math.pi * f_kick * tk) * torch.exp(-5.0 * tk / t["kick_s"])            # [rows, 1, L]
    on13 = beat_at[:, 0::2].to(torch.int64)
    _hits(out, on13, kick.expand(rows, on13.shape[1], kick_len))

    snare_len = int(t["snare_s"] * sr)
    ts = torch.arange(snare_len, device=device, dtype=torch.float64) / sr
    on24 = beat_at[:, 1::2].to(torch.int64)
    noise = torch.randn((rows, on24.shape[1], snare_len), generator=g, device=device, dtype=torch.float64)
    _hits(out, on24, 0.7 * noise * torch.exp(-5.0 * ts / t["snare_s"]))

    hat_len = int(t["hat_s"] * sr)
    th = torch.arange(hat_len, device=device, dtype=torch.float64) / sr
    eighth_at = torch.round(torch.arange(2 * beats, device=device, dtype=torch.float64)[None, :]
                            * period_s * (sr / 2.0)).to(torch.int64)
    noise = torch.randn((rows, eighth_at.shape[1], hat_len + 1), generator=g, device=device,
                        dtype=torch.float64)
    _hits(out, eighth_at, 0.25 * (noise[..., 1:] - noise[..., :-1]) * torch.exp(-5.0 * th / t["hat_s"]))
    return out / torch.clamp_min(out.abs().amax(dim=-1, keepdim=True), 1e-12)


def rhythmic(t: dict, g, rows: int, n: int, sr: int, device):
    """([rows, n] float64 tracks, [rows] tempo in BPM)."""
    bpm = _uniform(g, (rows, 1), t["tempo_low"], t["tempo_high"], device)
    period = 60.0 / bpm
    bars = 2.0 + 2.0 * torch.randint(0, 2, (rows, 1), generator=g, device=device).to(torch.float64)
    x = 0.5 * voices(t, g, bars * 4.0 * period, n, sr, device) + drums(t, g, period, n, sr, device)
    return x / torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-12), bpm[:, 0]


def beatless(t: dict, g, rows: int, n: int, sr: int, device):
    chord_s = _uniform(g, (rows, 1), t["chord_low"], t["chord_high"], device)
    return voices(t, g, chord_s, n, sr, device), torch.zeros(rows, device=device, dtype=torch.float64)


MAKERS = {"rhythmic": rhythmic, "beatless": beatless}


def make_labelled(t: dict, seed: int, device, sample_rate: int):
    """(`distinct` float32 [batch, n] batches on `device`, each row's kind
    per batch, each row's drawn tempo per batch (0 for beatless))."""
    sr = int(sample_rate)
    b, n = int(t["batch"]), int(round(t["clip_seconds"] * sr))
    counts = {k: int(t[k]) for k in KINDS}
    if sum(counts.values()) != b:
        raise ValueError(f"the kinds' counts {counts} do not add up to the batch {b}")
    g = generator(seed, device)
    batches, labels, tempi = [], [], []
    for _ in range(int(t["distinct"])):
        x = torch.empty((b, n), dtype=torch.float32, device=device)
        bpm = torch.zeros(b, dtype=torch.float64, device=device)
        order = torch.randperm(b, generator=g, device=device)
        kinds, lo = [""] * b, 0
        for kind in KINDS:
            rows = order[lo: lo + counts[kind]]
            lo += counts[kind]
            if not len(rows):
                continue
            tracks, tempo = MAKERS[kind](t, g, len(rows), n, sr, device)
            peak = _db(_uniform(g, (len(rows), 1), t["peak_db_low"], t["peak_db_high"], device))
            floor = _db(_uniform(g, (len(rows), 1), t["floor_db_low"], t["floor_db_high"], device))
            noise = torch.randn((len(rows), n), generator=g, device=device, dtype=torch.float64)
            x[rows] = (tracks * peak + floor * noise).to(torch.float32)
            bpm[rows] = tempo
            del tracks, noise
            for r in rows.tolist():
                kinds[r] = kind
        batches.append(x.contiguous())
        labels.append(kinds)
        tempi.append(bpm)
    return batches, labels, tempi


def make(t: dict, seed: int, device, sample_rate: int) -> List[torch.Tensor]:
    """`distinct` float32 [batch, n] batches on `device`."""
    return make_labelled(t, seed, device, sample_rate)[0]
