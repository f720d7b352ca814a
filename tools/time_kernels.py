#!/usr/bin/env python3
"""Time each hand-written CUDA kernel of the port on the card, in turns
with its plain PyTorch version, beside the least time the chip could take.

    python3 tools/time_kernels.py                 # this checkout's kernels
    python3 tools/time_kernels.py --root DIR TAG  # DIR's kernels, to compare trees

Needs a CUDA card; run from the root of a checkout. The card tests hold
the kernels to their plain versions (`tests/test_torch_card_kernels.py`);
this only times them. Inputs are utils/parity.synth_pcm and seeded numpy
draws at the main path's shapes: B=128 x 30 s, 44.1 kHz, 1024/256 (K2
and K3 at 1024/512; K2 with the period amplitude at voice quality's
1024/256 on speech-pre-emphasized PCM), the DTW at the fleet's two pairs
of 10,332 frames, band 5,167, and its sub-batch of 32.

Without --root it prints the card's name and power limit, the build
report (nvcc's registers and spills per kernel; shared memory and blocks
per SM of K1, K10, K2, K2 with the amplitude, K3, K4 and K9's two forms),
then one `{"kernels": [...]}` JSON line. Each entry holds the kernel's ms
by CUDA events (warm; the plain version's windows in turns with the
kernel's: plain, kernel, kernel, plain), `plain_ms`, `library_ms` where one
PyTorch call computes the same (K1: torch.stft), `bound_ms` and
`bound_by` (the larger of the bytes over 3.35 TB/s and the operations
over 67 TFLOP/s, benchmark/roofline/peaks.json; K1, K2, K2 with the
amplitude and the DTW fill count from benchmark/roofline/, the others
here), and `launches` per step of the path that runs it (main path,
generator, music program, fleet measure_all, the feature-epilogue
configuration; K3 has no caller). K4 adds `device_ms` (the kernel alone,
torch.profiler: its wrapper's host work is longer than the kernel); the
fill adds `ms_b32` and `parts` (pre-pass and row recurrence apart, us per
row, at B = 2, B = 32 and a band too wide for shared memory); K8 adds
`ms_b32`, `ms_l2_flushed`, `ms_b32_l2_flushed` (the 50 MB L2 overwritten
before each call, as the fleet finds it after a fill) and
`chain_floor_ms` (its longest path at one 30-cycle shared-memory round
trip a step, at the card's top SM clock); K10 adds `k1_ms_in_turns`
and `epilogue_ms` (K1 and K10 alternated, their difference).

With --root DIR TAG it builds and imports the package under DIR and
prints one JSON line: per geometry a hash of each kernel's outputs
(equal hashes: bit-equal outputs) and its ms, the DTW's parts apart. Run
it from each tree in one command, in turns (parent, change, change,
parent), to compare trees on one card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SR, WINDOW, HOP, PRE_EMPH = 44100, 1024, 256, 0.97
B, SECONDS = 128, 30
N = SECONDS * SR
K2_ARGS = (1024, 512, SR, 80.0, 1000.0, 0.15, PRE_EMPH)
VQ_ARGS = (1024, 256, SR, 50.0, 500.0, 0.15, 0.0)  # voice quality's K2 call
BAND = 30 * SR // HOP                     # 5,167: the fleet's 30 s budget
WIDE_BAND = 60 * SR // 128                # 20,671: rows too wide for shared memory
SMEM_ROUND_TRIP = 30                      # SM cycles of a dependent shared-memory load (an assumption)
UNRELATED_PAIR = 24                       # the fleet's first stream whose cdn is unrelated


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` launches, CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(fn, iters: int) -> float:
    """Mean device time of fn(), CUDA events around each call, the 50 MB
    L2 cache overwritten before each."""
    flush = torch.empty(2**26, dtype=torch.float32, device="cuda")  # 256 MiB
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        total += cuda_ms(fn, 1)
    return total / iters


def in_turns(kern, plain, iters: int, warm: bool = True) -> tuple:
    """(kernel ms, plain ms), each the mean of two CUDA-event windows run
    plain, kernel, kernel, plain; the plain windows take iters // 3 calls."""
    if warm:
        kern(), plain()
    p1 = cuda_ms(plain, max(iters // 3, 1))
    q1, q2 = cuda_ms(kern, iters), cuda_ms(kern, iters)
    p2 = cuda_ms(plain, max(iters // 3, 1))
    return (q1 + q2) / 2, (p1 + p2) / 2


def device_ms(fn, kernel: str, iters: int) -> float:
    """Mean device time in ms of the CUDA kernels whose name holds
    `kernel` over `iters` calls of fn(), by torch.profiler, after one
    warm-up call. Where a kernel takes less time than its wrapper's host
    work, CUDA events around the calls time the host; this reads the
    kernel alone. Raises if the profiler saw no such kernel."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if kernel in e.key]
    if not ev:
        raise RuntimeError(f"the profiler saw no kernel named {kernel}")
    return sum(e.self_device_time_total for e in ev) / sum(e.count for e in ev) / 1e3


def bound(nbytes: float, ops: float) -> tuple:
    """(least ms, what bounds it) under the chip's published peaks."""
    from benchmark.roofline.peaks import PEAKS

    by_bytes, by_ops = 1e3 * nbytes / PEAKS["hbm_bytes_per_s"], 1e3 * ops / PEAKS["fp32_ops_per_s"]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def sha(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def fleet_energies(dev) -> tuple:
    """The fleet's 64 x 60 s streams (utils/parity.alignment_streams with
    the card tests' lags and seeds, tests/card_support.dtw_draws) and
    their short-time energies [64, 10332, 1]."""
    from sonido_sonar_tpu_torch.ops.temporal import short_time_energy
    from sonido_sonar_tpu_torch.utils import parity

    rng = np.random.default_rng(10)
    rng.standard_normal((8, 2048, 12), dtype=np.float32)
    rng.standard_normal((1, 60 * SR // HOP, 12), dtype=np.float32)
    lags = rng.integers(int(0.1 * SR), 3 * SR, 64)
    unrelated = tuple(range(24, 32)) + tuple(range(56, 64))
    src, cdn = parity.alignment_streams(64, 60, SR, lags, 11, unrelated=unrelated, device=dev)
    return src, cdn, (short_time_energy(src, WINDOW, HOP)[..., None].contiguous(),
                      short_time_energy(cdn, WINDOW, HOP)[..., None].contiguous())


def build_report(lib, info) -> None:
    print(info.compiler_log.strip(), flush=True)
    from sonido_sonar_tpu_torch.ops.hopper_contrast import band_plan
    from sonido_sonar_tpu_torch.ops.spectral import contrast_band_edges

    def query(entry, *args, n_out):
        out = [ctypes.c_int() for _ in range(n_out)]
        code = getattr(lib, entry)(*args, *(ctypes.byref(v) for v in out))
        if code != 0:
            raise RuntimeError(f"{entry}{args}: {lib.sonido_error_string(code)}")
        return [v.value for v in out]

    for name, features in (("K1", 0), ("K10", 1)):
        smem, blocks = query("sonido_stft_occupancy", WINDOW, HOP, features, n_out=2)
        print(f"{name} at {WINDOW}/{HOP}: {smem} B of shared memory per block, {blocks} blocks per SM")
    for name, w, hop, rows in (("K2", 1024, 512, 0), ("K2 amp", 1024, 256, 0), ("K3", 1024, 512, 1)):
        smem, blocks = query("sonido_yin_occupancy", w, hop, rows, n_out=2)
        print(f"{name} at {w}/{hop}: {smem} B of shared memory per block, {blocks} blocks per SM")
    regs, local, smem, blocks = query("sonido_thin_onsets_occupancy", n_out=4)
    print(f"K4: {regs} registers, {local} B of local memory (spills), {smem} B of shared memory per block, "
          f"{blocks} blocks per SM")
    f_bins = WINDOW // 2 + 1
    for what, keys in (("lane plan", band_plan(contrast_band_edges(6, f_bins, SR), f_bins)[1]), ("general form", 0)):
        regs, local, smem, blocks = query("sonido_contrast_occupancy", keys, f_bins, n_out=4)
        print(f"K9 {what} ({keys} keys a lane) at F = {f_bins}: {regs} registers, {local} B of local memory "
              f"(spills), {smem} B of shared memory per block, {blocks} blocks per SM", flush=True)


def launches_per_step(dev, full, src, cdn) -> dict:
    """Each kernel's launches in one step of the path that runs it: the
    main path (K1, K2, K9), its feature-epilogue configuration (K10), the
    generator on news-labelled clips (K2 with the amplitude), the music
    program (K4) and the fleet's measure_all at 64 x 60 s (fill, K8)."""
    from sonido_sonar_tpu_torch import FleetMonitor
    from sonido_sonar_tpu_torch.config.config import FeatureConfig, FingerprintConfig
    from sonido_sonar_tpu_torch.fingerprint import FingerprintGenerator
    from sonido_sonar_tpu_torch.io.audio import AudioData, AudioMetadata
    from sonido_sonar_tpu_torch.ops import hopper_contrast, hopper_onsets, hopper_stft, hopper_yin
    from sonido_sonar_tpu_torch.ops.stats import hopper_backtrack, hopper_dtw
    from sonido_sonar_tpu_torch.parallel import pipeline

    counters = {"K1": (hopper_stft.stft_magnitude_hopper, "launches"),
                "K10": (hopper_stft.stft_magnitude_hopper, "feat_launches"),
                "K2": (hopper_yin.yin_pitch_hopper, "launches"),
                "K2amp": (hopper_yin.yin_pitch_hopper, "amp_launches"),
                "K3": (hopper_yin.yin_difference_hopper, "launches"),
                "K4": (hopper_onsets.thin_onsets_hopper, "launches"),
                "K9": (hopper_contrast.band_select_means_hopper, "launches"),
                "fill": (hopper_dtw.fill_banded_hopper, "launches"),
                "backtrack": (hopper_backtrack.backtrack_banded_hopper, "launches")}

    def counted(fn) -> dict:
        torch.cuda.synchronize()
        for f, attr in counters.values():
            setattr(f, attr, 0)
        fn()
        torch.cuda.synchronize()
        return {k: getattr(f, attr) for k, (f, attr) in counters.items()}

    cfg = FeatureConfig(sample_rate=SR, window_size=WINDOW, hop_size=HOP)
    main = counted(lambda: pipeline.batched_fingerprint_features(full, SR, WINDOW, HOP))
    os.environ[pipeline.FEAT_EPILOGUE_ENV] = "1"
    try:
        feat = counted(lambda: pipeline.batched_fingerprint_features(full, SR, WINDOW, HOP))
    finally:
        del os.environ[pipeline.FEAT_EPILOGUE_ENV]
    news = [AudioData(pcm=full[i], sample_rate=SR, metadata=AudioMetadata(extra={"content_type": "news"}))
            for i in range(B)]
    gen = FingerprintGenerator(FingerprintConfig(feature_config=cfg))
    generator = counted(lambda: gen.generate_fingerprints_batch(news, pcm_matrix=full, materialize=False))
    music = counted(lambda: pipeline.batched_music_extractor_features(full, SR, WINDOW, HOP))
    fleet = FleetMonitor(cfg, n_streams=64, window_seconds=60, max_lag_seconds=30, measure_batch=32, device=dev)
    fleet.push_source_all(src)
    fleet.push_cdn_all(cdn)
    measure = counted(lambda: fleet.measure_all(refine=True))
    return {"K1": main["K1"], "K2": main["K2"], "K9": main["K9"], "K10": feat["K10"],
            "K2amp": generator["K2amp"], "K3": 0, "K4": music["K4"], "fill": measure["fill"],
            "backtrack": measure["backtrack"]}


def fill_parts(q, r, band: int) -> dict:
    """The fill's distance pre-pass, its row recurrence (in place over the
    band, whose work does not depend on the values it holds) and the whole
    wrapper call, timed apart (CUDA events, after one call each)."""
    from sonido_sonar_tpu_torch.ops.stats import hopper_dtw as H

    n, m = q.shape[1], r.shape[1]
    local = H.local_distances_hopper(q, r, band, n, m)
    out = {}
    for name, fn in (("prepass", lambda: H.local_distances_hopper(q, r, band, n, m)),
                     ("rows", lambda: H.fill_rows_hopper(local, band, n, m)),
                     ("whole", lambda: H.fill_banded_hopper(q, r, band, n, m))):
        fn()
        out[f"{name}_ms"] = cuda_ms(fn, 2)
    out["rows_us_per_row"] = 1e3 * out["rows_ms"] / n
    return out


def kernels_line(dev) -> list:
    from benchmark.roofline import dtw as R_dtw
    from benchmark.roofline import k1 as R_k1
    from benchmark.roofline import k2 as R_k2
    from benchmark.roofline import k2amp as R_k2amp
    from sonido_sonar_tpu_torch.config.config import WindowType
    from sonido_sonar_tpu_torch.ops import hopper_contrast, hopper_onsets, hopper_stft, hopper_yin
    from sonido_sonar_tpu_torch.ops import temporal as T
    from sonido_sonar_tpu_torch.ops.filters import pre_emphasis, pre_emphasis_for_content
    from sonido_sonar_tpu_torch.ops.spectral import contrast_band_edges
    from sonido_sonar_tpu_torch.ops.stats import hopper_backtrack, hopper_dtw
    from sonido_sonar_tpu_torch.ops.stft import spectral_flux
    from sonido_sonar_tpu_torch.ops.tables import device_table
    from sonido_sonar_tpu_torch.ops.windows import make_window
    from sonido_sonar_tpu_torch.utils import parity

    k1, k1_plain = hopper_stft.stft_magnitude_hopper, hopper_stft.stft_magnitude_plain
    k2, k2_plain = hopper_yin.yin_pitch_hopper, hopper_yin.yin_pitch_plain
    k3, k3_plain = hopper_yin.yin_difference_hopper, hopper_yin.yin_difference_plain
    k4, k4_plain = hopper_onsets.thin_onsets_hopper, hopper_onsets.thin_onsets_plain
    k9, k9_plain = hopper_contrast.band_select_means_hopper, hopper_contrast.band_select_means_plain
    fill, fill_plain = hopper_dtw.fill_banded_hopper, hopper_dtw.fill_banded_plain
    walk, walk_plain = hopper_backtrack.backtrack_banded_hopper, hopper_backtrack.backtrack_banded_plain

    full = parity.synth_pcm(B, N, 1, SR, dev)
    src, cdn, (e_src, e_cdn) = fleet_energies(dev)
    launches = launches_per_step(dev, full, src, cdn)
    del src, cdn
    torch.cuda.empty_cache()
    t1, t2 = R_k1.frames(N, WINDOW, HOP), R_k2.frames(N, 1024, 512)
    feat_kw = dict(pre_emph=PRE_EMPH, with_features=True, sample_rate=SR)
    k = {}

    def entry(name, key, source, replaces, times, counts, **extra):
        bound_ms, bound_by = bound(*counts)
        k[key] = {"name": name, "route": "cuda", "source": f"sonido_sonar_tpu_torch/csrc/{source}",
                  "replaces": f"sonido_sonar_tpu/ops/{replaces}", "launches": launches[key],
                  "ms": times[0], "plain_ms": times[1], "library_ms": None,
                  "bound_ms": bound_ms, "bound_by": bound_by, **extra}
        torch.cuda.empty_cache()

    entry("K1 stft_magnitude_aux", "K1", "stft.cu", "pallas_stft.py:145",
          in_turns(lambda: k1(full, WINDOW, HOP, "hann", PRE_EMPH), lambda: k1_plain(full, WINDOW, HOP, "hann", PRE_EMPH), 10),
          R_k1.counts(B, N, WINDOW, HOP))
    xp = pre_emphasis(full, PRE_EMPH)
    hann = device_table(make_window, (WindowType.HANN, WINDOW), dev)
    f_bins = WINDOW // 2 + 1
    lib = torch.stft(xp, WINDOW, HOP, window=hann, center=False, return_complex=True).abs()
    if lib.shape != (B, f_bins, t1):
        raise AssertionError(f"torch.stft gave {tuple(lib.shape)}, K1 [{B}, {t1}, {f_bins}] transposed")
    del lib
    k["K1"]["library_ms"] = cuda_ms(
        lambda: torch.stft(xp, WINDOW, HOP, window=hann, center=False, return_complex=True).abs(), 10)
    del xp
    entry("K2 yin_pitch", "K2", "yin.cu", "pallas_yin.py:238",
          in_turns(lambda: k2(full, *K2_ARGS), lambda: k2_plain(full, *K2_ARGS), 10), R_k2.counts(B, N, 1024, 512))
    speech = pre_emphasis_for_content(full, "speech").contiguous()
    entry("K2 yin_pitch with_period_amp", "K2amp", "yin.cu", "pallas_yin.py:356",
          in_turns(lambda: k2(speech, *VQ_ARGS, with_period_amp=True),
                   lambda: k2_plain(speech, *VQ_ARGS, with_period_amp=True), 10), R_k2amp.counts(B, N, 1024, 256))
    del speech
    # K3 writes the difference rows: K2's operations less its ~10 a lag of
    # normalization and pick; bytes the PCM and the rows
    lags = k3(full, 1024, 512).shape[-1]
    k2_ops = R_k2.counts(B, N, 1024, 512)[1]
    entry("K3 yin_difference", "K3", "yin.cu", "pallas_yin.py:162",
          in_turns(lambda: k3(full, 1024, 512), lambda: k3_plain(full, 1024, 512), 10),
          (B * N * 4 + B * t2 * lags * 4, k2_ops - B * t2 * 10 * 1024 // 2))
    mag = k1(full, WINDOW, HOP, pre_emph=PRE_EMPH)[0]
    real = T.flux_onset_candidates(spectral_flux(k1(full, WINDOW, HOP)[0]), 0.3).contiguous()
    # K4 reads and writes one byte a frame, a compare a frame
    entry("K4 thin_onsets", "K4", "onsets.cu", "pallas_onsets.py:60",
          in_turns(lambda: k4(real, 8), lambda: k4_plain(real, 8), 10), (2 * real.numel(), real.numel()),
          device_ms=device_ms(lambda: k4(real, 8), "thin_kernel", 50))
    edges = contrast_band_edges(6, mag.shape[-1], SR)
    frames = mag.numel() // mag.shape[-1]
    # K9: the magnitudes read once, two means a band written; a linear-time
    # selection of the top and bottom k, a compare and an add per element
    # for each, over the bands' bins
    entry("K9 contrast_band_means", "K9", "contrast.cu", "pallas_contrast.py:140",
          in_turns(lambda: k9(mag, edges), lambda: k9_plain(mag, edges), 10),
          (mag.numel() * 4 + 2 * frames * 6 * 4, frames * (edges[-1] - edges[0]) * 4))
    del mag, real
    # K10: K1's work, then 43 feature lanes a frame written, ~15 operations
    # a bin and two (a multiply and an add) a sparse-table entry
    k1_bytes, k1_ops = R_k1.counts(B, N, WINDOW, HOP)
    table = hopper_stft.feature_tables(f_bins, SR, WINDOW)[1].size
    entry("K10 stft_features", "K10", "stft.cu", "pallas_stft.py:334",
          in_turns(lambda: k1(full, WINDOW, HOP, **feat_kw), lambda: k1_plain(full, WINDOW, HOP, **feat_kw), 10),
          (k1_bytes + B * t1 * 43 * 4, k1_ops + B * t1 * (15 * f_bins + 2 * table)))
    k10_ms, k1_ms = in_turns(lambda: k1(full, WINDOW, HOP, **feat_kw), lambda: k1(full, WINDOW, HOP, pre_emph=PRE_EMPH), 30)
    k["K10"].update(k1_ms_in_turns=k1_ms, epilogue_ms=k10_ms - k1_ms)
    del full
    torch.cuda.empty_cache()

    # the DTW at the fleet's two pairs (one related, one unrelated); no
    # warm-up: the plain fill at this size takes seconds
    pairs = [0, UNRELATED_PAIR]
    qe, re_ = e_src[pairs].contiguous(), e_cdn[pairs].contiguous()
    n = qe.shape[1]
    parts = {"B=2": fill_parts(qe, re_, BAND)}
    q32, r32 = e_src[:32].contiguous(), e_cdn[:32].contiguous()
    parts["B=32"] = fill_parts(q32, r32, BAND)
    rng = np.random.default_rng(5)
    qw, rw = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dev) for s in ((2, 3000, 1), (2, 2900, 1)))
    parts[f"[2, 3000 x 2900, 1] band {WIDE_BAND}"] = fill_parts(qw, rw, WIDE_BAND)
    entry("K5/K6/K7 dtw_fill_banded", "fill", "dtw.cu", "stats/pallas_dtw.py:297, :439, :173",
          in_turns(lambda: fill(qe, re_, BAND, n, n), lambda: fill_plain(qe, re_, BAND, n, n), 3, warm=False),
          R_dtw.counts(2, n, n, BAND), ms_b32=parts["B=32"]["whole_ms"], parts=parts)
    cost2 = fill(qe, re_, BAND, n, n)
    paths = walk(cost2, BAND, n, n)[3]
    steps, longest = int(paths.sum()), int(paths.max())
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    # K8 reads three neighbours and writes (q, r, cost) at each step of its paths
    entry("K8 dtw_backtrack_banded", "backtrack", "dtw.cu", "stats/pallas_backtrack.py:150",
          in_turns(lambda: walk(cost2, BAND, n, n), lambda: walk_plain(cost2, BAND, n, n), 3, warm=False),
          (steps * 24 + 2 * 4, steps * 6), ms_l2_flushed=cold_ms(lambda: walk(cost2, BAND, n, n), 3),
          chain_floor_ms=longest * SMEM_ROUND_TRIP / (mhz * 1e3))
    del cost2
    torch.cuda.empty_cache()
    cost32 = fill(q32, r32, BAND, n, n)
    k["backtrack"].update(ms_b32=cuda_ms(lambda: walk(cost32, BAND, n, n), 3),
                          ms_b32_l2_flushed=cold_ms(lambda: walk(cost32, BAND, n, n), 3))
    return list(k.values())


def tree_report(tag: str, dev) -> dict:
    """Per geometry a hash of each kernel's outputs and its ms (CUDA
    events, after three calls), through the wrappers of the imported tree."""
    from sonido_sonar_tpu_torch.ops import hopper_contrast, hopper_onsets, hopper_yin
    from sonido_sonar_tpu_torch.ops import temporal as T
    from sonido_sonar_tpu_torch.ops.filters import pre_emphasis_for_content
    from sonido_sonar_tpu_torch.ops.hopper_stft import stft_magnitude_hopper as k1
    from sonido_sonar_tpu_torch.ops.spectral import contrast_band_edges
    from sonido_sonar_tpu_torch.ops.stats import hopper_dtw as H
    from sonido_sonar_tpu_torch.ops.stats.hopper_backtrack import backtrack_banded_hopper as walk
    from sonido_sonar_tpu_torch.ops.stft import spectral_flux
    from sonido_sonar_tpu_torch.utils.parity import synth_pcm

    k2, k3 = hopper_yin.yin_pitch_hopper, hopper_yin.yin_difference_hopper
    k4, k9 = hopper_onsets.thin_onsets_hopper, hopper_contrast.band_select_means_hopper
    out = {"tag": tag, "card": card_line()}

    def case(name, fn, iters=10, **extra):
        got = fn()
        fn(), fn()  # the card's clocks ramp up over a fresh process's first calls
        got = got if isinstance(got, (tuple, list)) else (got,)
        flat = [t for g in got for t in (g.values() if isinstance(g, dict) else (g,))]
        out[name] = {"sha": sha(*flat), "ms": cuda_ms(fn, iters), **extra}

    for name, (batch, seconds, sr, w, hop) in {"main": (B, SECONDS, SR, WINDOW, HOP), "w64": (4, 5, SR, 64, 16),
                                               "w256_16k": (4, 5, 16000, 256, 100),
                                               "w2048": (4, 5, SR, 2048, 512)}.items():
        x = synth_pcm(batch, seconds * sr, 1, sr, dev)
        case(f"K1 {name}", lambda: k1(x, w, hop, pre_emph=PRE_EMPH))
        case(f"K10 {name}", lambda: k1(x, w, hop, pre_emph=PRE_EMPH, with_features=True, sample_rate=sr)[2])
    x = synth_pcm(B, N, 1, SR, dev)
    speech = pre_emphasis_for_content(x, "speech").contiguous()
    case("K2 main", lambda: k2(x, *K2_ARGS))
    case("K2amp main", lambda: k2(speech, *VQ_ARGS, with_period_amp=True))
    case("K3 main", lambda: k3(x, 1024, 512))
    del speech
    mag = k1(x, WINDOW, HOP, pre_emph=PRE_EMPH)[0]
    rng = np.random.default_rng(1)
    onsets = {"flux": (T.flux_onset_candidates(spectral_flux(mag), 0.3).contiguous(), 8),
              "rand30": (torch.from_numpy(rng.random((B, 5163)) < 0.3).to(dev), 8),
              "rand05_mf4": (torch.from_numpy(rng.random((B, 5165)) < 0.05).to(dev), 4)}
    for name, (cand, mf) in onsets.items():
        case(f"K4 {name}", lambda: k4(cand, mf), 50, device_ms=device_ms(lambda: k4(cand, mf), "thin_kernel", 50))
    x2 = synth_pcm(B, N, 2, SR, dev)
    for name, m in {"w1024": mag, "w2048": k1(x2, 2048, 1024, pre_emph=PRE_EMPH)[0]}.items():
        edges = contrast_band_edges(6, m.shape[-1], SR)
        case(f"K9 {name}", lambda: k9(m, edges), device_ms=device_ms(lambda: k9(m, edges), "band_means", 10))
    del x, x2, mag, onsets
    torch.cuda.empty_cache()

    rng = np.random.default_rng(5)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)

    for name, (q, r, band) in {"K6": (rand(8, 2048, 12), None, 64), "K7": (rand(1, 10335, 12), None, BAND),
                               "fleet": (rand(2, 10332, 1).abs(), None, BAND),
                               "wide": (rand(2, 3000, 1), rand(2, 2900, 1), WIDE_BAND),
                               "B32": (rand(32, 10332, 1).abs(), None, BAND)}.items():
        r = torch.roll(q, 7, 1).contiguous() if r is None else r
        n, m = q.shape[1], r.shape[1]
        cost = H.fill_banded_hopper(q, r, band, n, m)
        case(f"fill {name}", lambda: H.fill_banded_hopper(q, r, band, n, m), 2, **fill_parts(q, r, band))
        case(f"K8 {name}", lambda: walk(cost, band, n, m), 2, ms_l2_flushed=cold_ms(lambda: walk(cost, band, n, m), 2))
        del cost
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", nargs=2, metavar=("DIR", "TAG"),
                    help="time the kernels of the package under DIR and label the line TAG")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    if args.root:
        sys.path.insert(0, str(Path(args.root[0]).resolve()))
    from sonido_sonar_tpu_torch import _build

    lib, info = _build.build()
    dev = torch.device("cuda", 0)
    if args.root:
        print(json.dumps(tree_report(args.root[1], dev)), flush=True)
        return 0
    print(card_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; built {info.path.name} in {info.seconds:.1f} s")
    build_report(lib, info)
    print(json.dumps({"kernels": kernels_line(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
