#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold each
CUDA kernel to its plain PyTorch version.

    python3 chip_smoke.py

Run from the root of a checkout; it builds the kernels from the sources
in the checkout (nvcc, sm_90a) and needs one CUDA card. Phases, in order
(every failure raises, so the exit code is nonzero):

  1. the card's name and power limit (nvidia-smi)
  2. require CUDA; TF32 off
  3. build the kernels; the compiler's registers and spills, and K1's and
     K10's shared memory per block and resident blocks per SM at 1024/256,
     K2's at 1024/512 and 1024/256 (the period amplitude's), K3's at
     1024/512; K4's and K9's registers, spills, shared memory and blocks
     per SM
  4. K1 (STFT + aux) against its plain version, B=4 x 5 s and B=128 x 30 s
  5. K2 (YIN) against its plain version, same inputs; then K1, K2 and K3
     (YIN difference rows) at the other windows, hops and pre-emphasis
     values (512/128, 2048/512, 256/100) and at an odd hop (1024/255:
     frames off 8-byte alignment), K1 alone at W = 64 and 128, and K1 and
     K2 on a 1-D row
  6. the main path, batched_fingerprint_features, at B=128 x 30 s,
     44.1 kHz, window 1024, hop 256: shapes, finite values, K1, K2 and
     K9 launched once each, the contrast bit-equal to spectral_contrast
     of K1's magnitudes and within 1e-3 dB of the sorts' (K9's plain
     version), step time and audio-hours per wall-hour
  7. the main path at [2, 44100] on the card against the CPU, and at
     16 kHz ([2, 16000]): ZCR by the exact gate (every frame away from
     near-zero samples bit-equal)
  8. K1 and K2 against their plain versions, timed at the main path's shapes
  9. K2 with the period amplitude (voice quality: 1024/256, 50-500 Hz, on
     speech-pre-emphasized PCM) against its plain version, B=4 x 5 s and
     B=128 x 30 s: pitch gates as phase 5, the amplitude by the share of
     frames off (utils/parity.check_period_amp)
 10. K4 (onset thinning) against its plain version, bit for bit: the
     three thinning shapes of the music step at 30 s, random candidates at
     5 % and 30 % and the real flux candidates, min_frames 8 and 4;
     [3, 777] and a [2, 3, T] input; then the skip-ahead walk's edges at
     [128, 5163] (min_frames 40, 1 and 8 on rows that are full, empty or
     hold a lone candidate at T - 1), [2, 3, 5163], [4, 40000] at
     min_frames 20000 (past a tile) and [4, 40000] with onsets kept just
     before each tile edge at min_frames 1, 8, 40 and 100 (the walk
     carried into the next tile on the masked and the seek path), each
     also equal to the numpy model of the kernel's plan (ops/hopper_onsets)
 11. the wrappers on [2, 3, N] equal the same rows as [6, N] (K1, K2, K2
     with amplitude)
 12. the public path at full width: FingerprintGenerator (44.1 kHz,
     1024/256) on B=128 x 30 s news-labelled harmonic clips,
     generate_fingerprints_batch(pcm_matrix=..., materialize=False) then
     materialize(): launch counts (K1 >= 1, K2 >= 2 with one period-
     amplitude launch), the schema's shapes and dtypes, finite values,
     step time and audio-hours per wall-hour; then one batch without
     metadata (the acoustic detector routes; logged, not gated)
 13. the music program (batched_music_extractor_features) at B=128 x 30 s:
     K1 launched twice, K4 three times and K9 once (contrast), shapes,
     finite values, step time; batched_speech_extractor_features at the same shape
 14. the generator (both routings) and the music program at [2, 44100]
     on the card against the CPU, with utils/parity's gates; the music
     program also at 16 kHz ([2, 16000], ZCR by the exact gate)
 15. K2 with amplitude and K4 against their plain versions, timed (CUDA
     events); K4 also on the device alone (torch.profiler; the entry's
     `device_ms`), its wrapper's host work being longer than the kernel
 16. one torch.profiler step each of the generator and the music paths:
     the device's busy share and its top kernels
 17. the banded DTW fill (K5/K6/K7's counterpart: the distance pre-pass,
     then the row recurrence) against its plain version at the three TPU
     fills' geometries: [8, 2048, 12] band 64; [1, 10335, 12] band 5167
     (60 s chroma); [2, 10332, 1] band 5167 (fleet energy series); and
     [2, 3000 x 2900, 1] band 20671 (a 60 s budget at hop 128: rows too
     wide for shared memory, kept in the cost band); after each, the
     backtrack kernel (K8's) against the plain backtrack on the kernel's
     own band, exactly, with each pair's ring misses; the pre-pass alone
     against its plain version at K7's and the fleet's geometries
     (utils/parity.check_local_distances); the pre-pass, the recurrence
     and the whole call timed apart at the wide band, with us per row
 17b. K8 on prescribed-path bands built on the card
     (utils/parity.prescribed_path_band), n = m = 10,332: 3,000-step up
     and left runs, at band 5,167 also a left run to k = 0 and an up run
     back, and the same runs at the wide band 20,671: outputs bit-equal to
     the plain walk, the designed path followed, the misses equal to the
     numpy model's (ops/stats/hopper_backtrack.walk_model); ms and us per
     step
 18. the stream-alignment path at full width: FleetMonitor (44.1 kHz,
     1024/256), 64 streams x 60 s windows, 30 s budget, measure_batch 32,
     refine=True; 48 streams carry the source delayed 0.1-3 s x 0.9, 16
     (8 per sub-batch) an unrelated signal, so the 0.7 gate fails and DTW
     runs in both sub-batches: launch counts (fill and backtrack >= 2),
     every related stream within one hop of its lag, ms per measure_all
     (median of 3), streams per card at a 10 s cadence, peak memory; ms
     of both sides' whole-window pushes from card tensors and from numpy
     (staged through pinned memory), the windows unchanged by the latter
 19. LatencyMonitor at 60 s / 30 s (B = 1): one measure through the gate,
     one past it (the fill at B = 1); ms per measure() and of both sides'
     numpy pushes
 20. a 4-stream fleet (12 s, 3 s budget) and align_audio_files on the card
     against the CPU: offsets and methods equal, scores within 1e-4
 21. fill and backtrack against their plain versions, timed at the fleet
     geometry (B = 2); the fill's pre-pass, recurrence and whole call timed
     apart at B = 2 and B = 32, the fleet's sub-batch, with us per row and
     the bytes bounds; the kernels at B = 32,
     with pairs 0, 24 (unrelated) and 31 of it held to the plain fill and
     the plain backtrack (their offsets in the band pass 2^31 elements
     from pair 21 on), K8's outputs bit-equal and its misses equal to the
     model's at B = 2 and on those pairs, its time warm and with the L2
     cache flushed (as the fleet finds it after a fill), us per step, the
     chain floor, and a `K8 ring` JSON line; the hybrid's host reads
     under CUDA's sync debug mode (one for batched_hybrid_align, none for
     batched_hybrid_align_device, same offsets and methods)
 22. one torch.profiler step of the fleet's measure_all
Phases 28-29 run right after phase 12, on its batch:
 28. the comparator at full width: FingerprintBatch.comparator_matrix(13)
     of phase 12's batch, [128, 70] float32 on the card, against the host
     packer over the materialized fingerprints (utils/parity
     .COMPARATOR_PACK_SCALED_ATOL after scaling by max(|x|, 1));
     PackedCorpus.from_batch's content codes equal PackedCorpus.build's;
     the generate + pack step (bench.py:396-493's generate-batch shape,
     fenced on the matrix): launch counts (K1 >= 1, K2 >= 2 with one
     period-amplitude launch), ms per step and audio-hours per wall-hour;
     search_corpus for 4 queries from the batch on the card and on the
     same corpus on the CPU: the same ids in the same order (a run of
     similarities within COMPARATOR_HOST_ATOL compared as a set), the
     similarities within that bound
 29. corpus scale: 262,144 packed rows from numpy (bench.py:585-595), 64
     of them copies of one row; batched_similarity on 4,096 rows, card
     against CPU (COMPARATOR_HOST_ATOL); topk_similarity at k = 16 with
     the CPU's ranking for a random query (runs of scores within that
     bound compared as sets: the recipe's top scores crowd within ~1e-7)
     and, exactly, for the duplicated row, whose tied rows come lowest
     index first; batched_similarity and topk_similarity timed (CUDA
     events), one blocking search_corpus and search_corpus_stream at
     depth 4 (host clock, ms per query and comparisons per second; the
     query's host pack timed apart), one torch.profiler window of the
     stream; topk_similarity_multi at Q = 64, k = 16 against
     topk_similarity row by row (as the random query), timed;
     batched_similarity_detailed at C = 4,096 with 5,164-frame series (a
     one-frame and a constant series among them), card against CPU; the
     peak device memory; a call with TF32 matmuls on raises
Phases 23-27 run right after phase 8, while the B=128 x 30 s PCM is on
the card:
 23. K10 (K1's feature epilogue) against its plain version, B=4 x 5 s and
     B=128 x 30 s, and at 64/16 (44.1 kHz), 256/100 (16 kHz), 1024/255
     and 2048/512 (44.1 kHz) on [3, sr + 777]: magnitudes and aux
     bit-equal to the launch without features; feat bit-equal between
     two launches; the lanes against the plain epilogue on the kernel's
     own magnitudes (utils/parity.FEAT_SAME_MAGNITUDES), and at the small
     shapes against the whole plain version (across the two DFTs)
 24. the main path in its feature-epilogue configuration
     (SONIDO_ENABLE_FEAT_EPILOGUE=1) at B=128 x 30 s: K1, K10, K2 and K9
     launched once each, the
     default configuration's keys, shapes and dtypes, finite values,
     agreement with the default configuration's outputs; both
     configurations' step times in turns; the configuration at
     [2, 44100] on the card against the CPU
 25. K9 (contrast band means) at the main path's magnitudes
     [128, 5164, 513] with the 6 contrast edges against its plain
     version (the contrast sorts), and
     the tie and zero case exactly; two launches bit-equal; then at full
     size ties at the k-th key, zero and subnormal powers, one constant
     band, degenerate bands, the 22.05 kHz edges and W = 2048 (the lane
     plan) and W = 4096 (the general form: 70 keys a lane), each against
     its plain version with two launches bit-equal and against the numpy
     model of the lane plan on 4,096 frames
 26. K3 at B=128 x 30 s, 1024/512, driven once as its public op, then
     against its plain version
 27. K10, K9 and K3 against their plain versions, timed; K1 and K10 in
     turns (K1, K10, K10, K1) with their difference, the feature
     epilogue's time; and K1 against torch.stft

Phases 30-32 run right after phase 14, on phase 12's clips:
 30. the extractor class compositions at full width, B=128 x 30 s,
     1024/256: FingerprintGenerator(strict_reference_routing=False) on a
     sports-labelled and a mixed-labelled batch,
     generate_fingerprints_batch(pcm_matrix=..., materialize=False) then
     materialize() (the class composition over ops.stft.stft); then
     SpeechFeatureExtractor(is_news=True) and MusicFeatureExtractor
     extract_features over stft of the same PCM, with the generator's
     news and music feature configs: launch counts (sports K2 >= 1;
     mixed and speech K2 >= 2 with one period-amplitude launch; music
     K1 >= 1 and K4 >= 1), the schema's shapes and dtypes, finite
     values, sports' per-clip excitement lists on every fingerprint, ms
     per step (3 steps), audio-hours per wall-hour, peak memory, and one
     torch.profiler step of each path (busy share, top kernels)
 31. the four compositions at [2, 44100] on the card against the CPU
     (utils/parity.check_extracted and check_metadata); the speech and
     music programs against their compositions on the card; the music
     composition at 16 kHz ([2, 16000], ZCR by the exact gate)
 32. STFTStreamer at 1024/256 on the card: a 60 s stream pushed in 1 s
     chunks in legacy and in block mode (64 frames), K1 launched once a
     result (legacy) or a block, the concatenated magnitudes against
     stft of the whole signal (utils/parity.MAG_ATOL_SCALE), ms per push;
     a 4096-window streamer takes the stft route with no K1 launch

Phases 33-36 run right after phase 22 (the ingest layer and the user
entry points, from WAV files in a temporary directory):
 33. ingest: 64 mono 16-bit WAVs of 30 s at 44.1 kHz (speech-like,
     music-like and harmonic tones, seeded from SEED) written with the
     port's write_wav, and 4 stereo 16-bit 48 kHz WAVs written with the
     stdlib; the native loader asserted available (built with g++);
     decode_files_parallel on the native path and on the decoder's
     stdlib path, every file's PCM within 1e-6 of the stdlib read (the
     48 kHz files through _resample_polyphase); ms per file and
     audio-hours of ingest per wall-hour
 34. examples.cdn_latency.main at full width: 60 s speech-like and
     music-like sources, the CDN copy delayed by 1.234 s + 137 samples
     (gain 0.9, noise 0.02), a 30 s budget: the refined latency within one
     hop, launches, the stage split (decode, fingerprints, alignment,
     refine), the first call against the warm one and a fresh process's
     run beside the nvcc build; examples.corpus_search.main over phase
     33's 64 files with a query of file 17 plus noise: rank 1 is file 17
 35. the accuracy sweep on the card: eval_accuracy.run_extended at 44.1
     kHz, full, held to every gate of tests/test_eval_gates.py (a miss
     raises); eval_accuracy.run at 44.1 kHz, full, batched (coarse offsets
     identical to the per-pair ones); run_extended at 22.05 kHz, quick,
     on the card and the CPU with equal per-category within-one-hop rates
 36. models.FingerprintModel over 8 host batches of 128 x 30 s under
     parallel.pipeline.run_stream(drain_every=2) and as blocking calls:
     outputs bit-equal in order, audio-hours per wall-hour both ways, the
     busy share of a profiled window; examples.batch_monitor.main at its
     defaults and at 64 pairs x 60 s (exact-sample recovery); one
     main-path step under utils.profiler_trace in a fresh process and
     the same step 3 times in this process, each trace holding a kernel
     record for each of its launch calls (as many calls in all) and
     naming K1's kernel (the same step traced here by a bare
     torch.profiler session, without profiler_trace's warm-up step, in
     turns with those, is logged)

Phases 37 and 38 run last (the music-analysis ops, then the op surface):
 37. the music program with enable_cqt and enable_hpcp at B=128 x 30 s
     on phase 13's clips: K1 launched twice, K4 three times, K9 once, the
     schema's shapes with chroma_cqt [128, 2568, 12] and hpcp [128,
     5164, 12], unit-sum CQT and unit-energy HPCP rows, steps in turns
     with the options-off program, chroma_cqt and hpcp_from_magnitude
     timed apart (CUDA events), peak device memory; the same call card
     against CPU at [2, 44100] and at 16 kHz; the tonal surface on the
     card held to the CPU on 4 clips: KeyEstimator.estimate_key_sequence,
     ChordDetector.detect_sequence and ChordProgressionAnalyzer.analyze
     over the program's chroma of 4 clips whose chords and key change
     (the keys, modulations and chord changes must not be all alike),
     PitchDetector.detect_track for every method and the yin+acf hybrid
     (1024/512, run at full width), HarmonicRatioAnalyzer.analyze_spectrum
     and spectral_snr, analyze_inharmonicity and analyze_vibrato over the
     full-width magnitudes and tracks, HarmonicTracking on one clip; each
     tonal op timed as the median of 3 calls after a warm-up
 38. the op surface at B=128 x 30 s (run_op_surface): the normalizers
     (quantile and robust over 169 M samples), resampling to 16 kHz by
     all four interpolators, the block-scan filters, envelopes, energy
     statistics, estimate_tempo_range (K1, K4), VAD and speech segments,
     LPC residuals and LUFS over the PCM; complex-domain onsets (K4) over
     a full stft's magnitude and phase, mel, Bark and custom-band
     contrast over K1's magnitudes; k-means (K = 8) over the main path's
     661k MFCC frames, a JS distance matrix over one clip's chroma, kNN
     over phase 29's corpus (the 16 lowest of the 65 tied copies), the
     moments, entropy and percentile analyses, the chroma statistics and
     Tonnetz and tension ops over the batch's chroma; all six chroma
     sequence similarities (DTW banded) on a chord clip against its
     chroma transposed by 5 (OTI must find 5). Each op timed as the
     median of 3 calls after a warm-up and held to the same op on the
     CPU over 2 clips (utils/parity OPS_*, MOMENTS_RTOL, BLOCK_SCAN_*,
     SW_ATOL_SCALE); launches K1 and K4 only; peak device memory

Phases 39 and 40 run after them (scale-out and cold start):
 39. BatchedFingerprintPipeline at B=128 x 30 s on a one-entry mesh (the
     card, make_mesh()) and a two-entry mesh on the one card
     (make_mesh(devices=[cuda:0, cuda:0]): a repeated entry is a shard run
     after the other): K1 and K2 launched once per shard, the features
     against batched_fingerprint_features (utils/parity
     .check_sharded_step: bit for bit, or a key that is not held to the
     whole-path bounds; the worst difference printed), the host's
     synchronizations in one sharded step (CUDA's sync debug mode), the
     unsharded step and both meshes' steps in turns over 5 steps each
     with audio-hours per wall-hour; run_stream over the two-entry
     pipeline equal to blocking calls; sharded_top_k_matches and
     sharded_batched_similarity over phase 29's 262,144 rows on both
     meshes against mesh=None (the ranking, ties lowest index first; the
     scores within COMPARATOR_HOST_ATOL), ms per query; a fresh process
     with an NCCL group of world size 1 (initialize_distributed, the
     global mesh, the pipeline on a one- and a two-entry mesh and the
     all-gather merge of the top k against the same calls without the
     group, destroy_process_group). One H100 holds no NCCL group of two
     ranks: the two-process path is checked on the CPU only
     (tests/test_torch_multihost.py)
 40. warm-up in three fresh processes sharing one temporary cache_dir:
     warmup(cache_dir=...) at B=128 x 30 s, alignment pairs (1, 32) and a
     262,144-row corpus builds the library there with nvcc (hit count 0);
     a second process loads it without nvcc (hit count 1), warms the
     cdn_latency shape and times two examples.cdn_latency calls on a 60 s
     speech pair; a third loads it and times the same calls without a
     warm-up; each stage's seconds

A {"comparator": {...}} line (the card, phases 28-29's gates, launch
counts and times), an {"extractor_classes": {...}} line (phases
30-32's launch counts, step times, peak memory and the streamer's
numbers) and the {"ingest": ...}, {"cdn_latency": ...}, {"accuracy": ...},
{"stream": ...}, {"music_analysis": ...}, {"op_surface": ...}, {"mesh": ...}
and {"warmup": ...} lines of phases 33-40 (each
path's kernel launches, counted from 0 just before it) come before the
kernels line. The second-to-last line
is {"kernels": [...]}: for each kernel its
launches on its path, its largest error against its plain version, its
time, the plain version's, its bound (the larger of the bytes it must move
over 3.35 TB/s and its operations over 67 TFLOP/s, the H100's fp32 rate
outside the tensor cores, from this run's shapes) and, where one PyTorch
call computes the same function, that call's time; the DTW fill and K8
also carry their time at B = 32, the fleet's sub-batch (`ms_b32`), and K9
its launches on the main path (phase 6) and that path's contrast gap to
the sorts in dB (`contrast_gap_db`). The
last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Inputs are harmonic tones plus noise (utils/parity.synth_pcm and
utils/parity.harmonic_clips), drawn with numpy from SEED.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

SEED = 0
SR = 44100
WINDOW, HOP = 1024, 256
PITCH_WINDOW, PITCH_HOP = 1024, 512
PRE_EMPH = 0.97
FULL_B, FULL_SECONDS = 128, 30  # bench.py's headline shape
SMALL_B, SMALL_SECONDS = 4, 5
TIMED_STEPS = 5
SURFACE_STEPS = 3  # timed steps of the generator and the music program
VQ_ARGS = (1024, 256, SR, 50.0, 500.0, 0.15, 0.0)  # voice quality's K2 call
OUTPUT_KEYS = (
    "mfcc", "chroma", "spectral_centroid", "spectral_bandwidth", "spectral_flatness",
    "spectral_crest", "spectral_slope", "spectral_flux", "spectral_contrast", "zcr",
    "spectral_rolloff", "low_energy_ratio", "high_energy_ratio", "rms_energy",
    "energy_entropy", "energy_variance", "pitch", "pitch_confidence", "voicing",
)


HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
CONTRAST_GAP_DB = 1e-3      # the main path's contrast against the sorts' (the tests' atol)
SMEM_ROUND_TRIP = 30        # SM cycles of a dependent shared-memory load (an assumption)
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float) -> tuple:
    """(least ms, what bounds it): the larger of the bytes over the memory
    rate and the operations over the fp32 rate."""
    by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / FP32_OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def stft_ops(w: int) -> float:
    """Operations per frame of the STFT: window, an FFT of W/2 complex
    points (5 N log2 N, the radix-2 count), the real split and magnitude
    (~20 per bin), the aux sums (~4 per bin and 3 per sample)."""
    f_bins = w // 2 + 1
    return w + 5 * (w // 2) * np.log2(w // 2) + 24 * f_bins + 3 * w


def yin_ops(w: int) -> float:
    """Operations per frame of the difference function d = E1 + S - 2 r in
    its least-work form, the one the plain version and the TPU kernel
    take: r(tau) as a cross-correlation through real FFTs of W points (two
    forward and one inverse, 2.5 W log2 W each, and a complex product of 6
    per bin), E1 and S from a prefix sum of squares (2 per sample), and
    3 per lag to combine them (H = W/2 lags)."""
    return 3 * 2.5 * w * np.log2(w) + 6 * (w // 2 + 1) + 2 * w + 3 * (w // 2)


def in_turns(kern, plain, iters: int, warm: bool = True) -> tuple:
    """(kernel ms, plain ms), each the mean of two CUDA-event windows run
    plain, kernel, kernel, plain; the plain windows take iters // 3
    calls."""
    if warm:
        kern(), plain()
    p1 = cuda_ms(plain, max(iters // 3, 1))
    q1 = cuda_ms(kern, iters)
    q2 = cuda_ms(kern, iters)
    p2 = cuda_ms(plain, max(iters // 3, 1))
    return (q1 + q2) / 2, (p1 + p2) / 2


def hold_k3(x: torch.Tensor, w: int, hop: int) -> tuple:
    """K3 against its plain version on the same input: (max |d - plain|,
    d's shape); raises past utils/parity.YIN_DIFF_ATOL_SCALE of the
    largest |d|."""
    from sonido_sonar_tpu_torch.ops import hopper_yin
    from sonido_sonar_tpu_torch.utils import parity

    d = hopper_yin.yin_difference_hopper(x, w, hop)
    pd = hopper_yin.yin_difference_plain(x, w, hop)
    torch.cuda.synchronize()
    if d.shape != pd.shape:
        raise AssertionError(f"K3: shape {tuple(d.shape)}, plain {tuple(pd.shape)}")
    scale = float(pd.abs().max())
    err = float((d - pd).abs().max())
    log(f"[K3 vs plain, {tuple(x.shape)}, {w}/{hop}] max |d - plain| {err:.4g} = "
        f"{err / scale:.3g} of the largest |d| (limit {parity.YIN_DIFF_ATOL_SCALE})")
    if not err <= parity.YIN_DIFF_ATOL_SCALE * scale:
        raise AssertionError(f"K3 disagrees with its plain version at {w}/{hop}")
    return err, tuple(d.shape)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def np32(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def require(report, what: str) -> dict:
    errors, failures = report
    log(f"[{what}] " + ", ".join(f"{k}={v:.3g}" for k, v in errors.items()))
    if failures:
        raise AssertionError(f"{what}: " + "; ".join(failures))
    return errors


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` launches, CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def warm_median_ms(fn, iters: int):
    """(fn()'s result, the median ms of `iters` more calls): one warm-up
    call first (cuFFT plans, allocator growth), then CUDA events around
    each call, the device synchronized before each; for a call that waits
    on the host the time spans its host work too."""
    out = fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return out, float(np.median(times))


def cold_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` launches, CUDA events around
    each, the 50 MB L2 cache overwritten before each (as a caller right
    after a fill of gigabytes finds it)."""
    flush = torch.empty(2**26, dtype=torch.float32, device="cuda")  # 256 MiB
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def timed_steps(fn, steps: int) -> list:
    """Host-clock seconds of `steps` synchronized calls of fn()."""
    out = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def report_steps(what: str, step_s: list, audio_s: float, card: str) -> float:
    ms = 1e3 * float(np.mean(step_s))
    log(f"{what}: {ms:.2f} ms/step (steps {', '.join(f'{1e3 * s:.2f}' for s in step_s)}), "
        f"{audio_s / float(np.mean(step_s)):.0f} audio-h per wall-h [{card}]")
    return ms


def profile_step(what: str, fn, top: int = 12) -> float:
    """One torch.profiler step of fn(): logs the device's busy share
    (kernel time over wall time), which it returns, and the kernels with
    the most device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"[profile {what}] {1e3 * wall:.2f} ms wall (profiled), device busy "
        f"{1e-3 * busy_us:.2f} ms = {100 * busy_us * 1e-6 / wall:.1f} %")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile {what}] {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  {e.key[:90]}")
    return busy_us * 1e-6 / wall


def check_surface(what: str, arrays: dict, expect: dict, ints: dict) -> None:
    """Every array finite, float32 unless `ints` names its dtype, and of
    the shape `expect` gives where it names one."""
    for key, v in arrays.items():
        dtype = ints.get(key, torch.float32)
        if v.dtype != dtype:
            raise AssertionError(f"{what} {key}: {v.dtype}, expected {dtype}")
        if key in expect and tuple(v.shape) != expect[key]:
            raise AssertionError(f"{what} {key}: shape {tuple(v.shape)}, expected {expect[key]}")
        if v.dtype.is_floating_point and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{what} {key}: non-finite values")
    missing = sorted(set(expect) - set(arrays))
    if missing:
        raise AssertionError(f"{what}: missing {missing}")
    log(f"[{what}] {len(arrays)} outputs: shapes and dtypes as expected, all finite")


def news_schema(b: int, n: int) -> dict:
    """The ExtractedFeatures fields of the speech extractor with every
    stage on (news), at 1024/256, as features_to_numpy paths -> shapes."""
    t = (n - WINDOW) // HOP + 1
    tp = (n - 1024) // 512 + 1
    frame = {k: (b, t) for k in (
        "spectral_features.spectral_centroid", "spectral_features.spectral_rolloff",
        "spectral_features.spectral_bandwidth", "spectral_features.spectral_flatness",
        "spectral_features.spectral_crest", "spectral_features.spectral_slope",
        "spectral_features.spectral_flux", "spectral_features.zero_crossing_rate",
        "temporal_features.rms_energy", "energy_features.short_time_energy",
        "energy_features.energy_entropy", "energy_features.low_energy_ratio",
        "energy_features.high_energy_ratio")}
    pitch = {f"harmonic_features.{k}": (b, tp) for k in (
        "pitch_estimate", "pitch_confidence", "voicing_strength", "harmonic_ratio",
        "inharmonicity_ratio", "tonal_centroid")}
    scalar = {k: (b,) for k in (
        "speech_features.vocal_tract_length", "speech_features.speech_rate",
        "speech_features.pause_count", "speech_features.formant_count",
        "speech_features.jitter", "speech_features.shimmer",
        "temporal_features.peak_amplitude", "temporal_features.average_amplitude",
        "temporal_features.dynamic_range", "temporal_features.silence_ratio",
        "temporal_features.onset_density", "energy_features.energy_variance",
        "energy_features.loudness_range")}
    return {
        **frame, **pitch, **scalar,
        "mfcc": (b, t, 13), "spectral_features.spectral_contrast": (b, t, 6),
        "speech_features.formant_frequencies": (b, 1, 4),
        "speech_features.voicing_probability": (b, tp),
        "speech_features.spectral_tilt": (b, tp),
        "speech_features.pause_duration": (b, 64),
        "temporal_features.onset_mask": (b, t - 1),
        "temporal_features.attack_time": (b, t - 1),
        "temporal_features.envelope_shape": (b, (n - 512) // 256 + 1),
    }


NEWS_INTS = {"speech_features.formant_count": torch.int32,
             "speech_features.pause_count": torch.int32,
             "temporal_features.onset_mask": torch.bool}


def music_schema(b: int, n: int) -> dict:
    t = (n - WINDOW) // HOP + 1
    per_frame = ("spectral_centroid", "spectral_bandwidth", "spectral_flatness", "spectral_crest",
                 "spectral_slope", "spectral_flux", "spectral_rolloff", "zcr", "chord_index",
                 "chord_score", "rms_energy", "onset_mask", "attack_time", "crest_factor",
                 "energy_entropy", "low_energy_ratio", "high_energy_ratio", "pitch",
                 "pitch_confidence", "voicing", "hnr", "inharmonicity", "tonal_centroid")
    scalar = ("onset_density", "peak_amplitude", "average_amplitude", "dynamic_range",
              "silence_ratio", "tempo_bpm", "energy_variance", "loudness_range")
    env_frame = max(n // t, 1)
    return {**{k: (b, t) for k in per_frame}, **{k: (b,) for k in scalar},
            "spectral_contrast": (b, t, 6), "mfcc": (b, t, 13), "chroma": (b, t, 12),
            "key_correlations": (b, 24), "envelope_shape": (b, (n - env_frame) // HOP + 1)}


MUSIC_INTS = {"chord_index": torch.int32, "onset_mask": torch.bool}


def music_class_schema(b: int, n: int) -> dict:
    """The music composition's ExtractedFeatures fields (the music
    content's feature config: every family but speech) at 1024/256, as
    features_to_numpy paths -> shapes."""
    t = (n - WINDOW) // HOP + 1
    frame = [f"spectral_features.{k}" for k in (
        "spectral_centroid", "spectral_rolloff", "spectral_bandwidth", "spectral_flatness",
        "spectral_crest", "spectral_slope", "spectral_flux", "zero_crossing_rate")]
    frame += [f"temporal_features.{k}" for k in ("rms_energy", "crest_factor", "onset_mask", "attack_time")]
    frame += [f"energy_features.{k}" for k in (
        "short_time_energy", "energy_entropy", "low_energy_ratio", "high_energy_ratio")]
    frame += [f"harmonic_features.{k}" for k in (
        "pitch_estimate", "pitch_confidence", "voicing_strength", "harmonic_ratio",
        "inharmonicity_ratio", "tonal_centroid")]
    scalar = [f"temporal_features.{k}" for k in (
        "peak_amplitude", "average_amplitude", "dynamic_range", "silence_ratio", "onset_density",
        "tempo_bpm")] + ["energy_features.energy_variance", "energy_features.loudness_range"]
    return {**{k: (b, t) for k in frame}, **{k: (b,) for k in scalar},
            "mfcc": (b, t, 13), "chroma_features": (b, t, 12),
            "spectral_features.spectral_contrast": (b, t, 6),
            "temporal_features.envelope_shape": (b, (n - max(n // t, 1)) // HOP + 1)}


CLASS_STEPS = 3                       # timed steps of each phase-30 path
STREAM_SECONDS, STREAM_BLOCK = 60, 64  # phase 32: a 60 s stream in 1 s pushes


def run_extractor_classes(card: str, dev: torch.device, clips: torch.Tensor, gen_cfg) -> dict:
    """Phases 30-32: the extractor class compositions at full width on
    `clips` (the generator under non-strict routing on sports- and
    mixed-labelled batches, the speech and music compositions over
    `stft`), the four compositions on the card against the CPU and the
    speech and music programs against their compositions, and
    STFTStreamer on K1. Returns the {"extractor_classes": ...} numbers."""
    from sonido_sonar_tpu_torch.config.config import ContentType
    from sonido_sonar_tpu_torch.extractors import (
        MixedFeatureExtractor,
        MusicFeatureExtractor,
        SpeechFeatureExtractor,
        SportsFeatureExtractor,
    )
    from sonido_sonar_tpu_torch.fingerprint import FingerprintGenerator
    from sonido_sonar_tpu_torch.io.audio import AudioData, AudioMetadata
    from sonido_sonar_tpu_torch.ops import hopper_onsets, hopper_stft, hopper_yin
    from sonido_sonar_tpu_torch.ops.filters import dc_removal, pre_emphasis_for_content
    from sonido_sonar_tpu_torch.ops.stft import STFTStreamer, stft
    from sonido_sonar_tpu_torch.utils import parity
    from sonido_sonar_tpu_torch.utils.convert import features_to_numpy, flatten_features

    started = time.perf_counter()
    k1, k2, k4 = (hopper_stft.stft_magnitude_hopper, hopper_yin.yin_pitch_hopper,
                  hopper_onsets.thin_onsets_hopper)

    def zero_counts():
        k1.launches = k2.launches = k2.amp_launches = k4.launches = 0

    def counts():
        return {"K1": k1.launches, "K2": k2.launches, "K2amp": k2.amp_launches, "K4": k4.launches}

    b, n = clips.shape
    t = (n - WINDOW) // HOP + 1
    news = news_schema(b, n)
    onsets = {"temporal_features.onset_mask": torch.bool}
    schemas = {
        "sports": ({k: v for k, v in news.items() if not k.startswith("speech_features.")}, onsets),
        "mixed": ({**news, "chroma_features": (b, t, 12)}, NEWS_INTS),
        "speech": (news, NEWS_INTS),
        "music": (music_class_schema(b, n), onsets),
    }
    # the launches each path must show at least
    need = {"sports": {"K2": 1}, "mixed": {"K2": 2, "K2amp": 1}, "speech": {"K2": 2, "K2amp": 1},
            "music": {"K1": 1, "K4": 1}}
    gen = FingerprintGenerator(gen_cfg, strict_reference_routing=False)
    classes = {  # on the generator's feature config of each content type
        "speech": SpeechFeatureExtractor(gen._feature_config_for(ContentType.NEWS, SR), is_news=True),
        "music": MusicFeatureExtractor(gen._feature_config_for(ContentType.MUSIC, SR)),
        "sports": SportsFeatureExtractor(gen._feature_config_for(ContentType.SPORTS, SR)),
        "mixed": MixedFeatureExtractor(gen._feature_config_for(ContentType.MIXED, SR)),
    }

    def compose(label, x, sr=SR):
        return classes[label].extract_features(stft(x, WINDOW, HOP, sample_rate=sr), x, sr)

    def generate(label):
        audios = [AudioData(pcm=clips[i], sample_rate=SR,
                            metadata=AudioMetadata(extra={"content_type": label})) for i in range(b)]
        return lambda: gen.generate_fingerprints_batch(audios, pcm_matrix=clips, materialize=False)

    paths = {"sports": generate("sports"), "mixed": generate("mixed"),
             "speech": lambda: compose("speech", clips), "music": lambda: compose("music", clips)}
    res = {"card": card, "B": b, "seconds_of_audio": FULL_SECONDS, "paths": {}}
    for label, step in paths.items():                          # phase 30
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        out = step()
        torch.cuda.synchronize()
        launches = counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        log(f"[{label} composition B={b} x {FULL_SECONDS} s] launches {launches}, peak device "
            f"memory {peak_gib:.2f} GiB [{card}]")
        short = {k: launches[k] for k, least in need[label].items() if launches[k] < least}
        if short:
            raise AssertionError(f"the {label} composition missed a kernel: {short}, needs {need[label]}")
        schema, ints = schemas[label]
        if label in ("sports", "mixed"):
            (ct, idxs, feats), = out.groups
            if ct.value != label or len(idxs) != b:
                raise AssertionError(f"generator grouped {ct} x {len(idxs)}")
            if feats.metadata["extractor_type"] != label:
                raise AssertionError(f"{label} group: extractor_type {feats.metadata['extractor_type']}")
        else:
            feats = out
        check_surface(f"{label} composition", flatten_features(feats), schema, ints)
        if label in ("sports", "mixed"):
            fps = out.materialize()
            one = features_to_numpy(fps[-1].features)
            for k, shape in schema.items():
                if one[k].shape != shape[1:]:
                    raise AssertionError(f"materialized {label} {k}: {one[k].shape}, expected {shape[1:]}")
            if label == "sports":
                for key in ("excitement_variance", "excitement_entropy"):
                    vals = feats.metadata[key]
                    if (len(vals) != b or not np.isfinite(vals).all()
                            or any(fp.features.metadata[key] != vals for fp in fps)):
                        raise AssertionError(f"sports metadata {key}: not the group's {b} finite values")
            log(f"[{label} generator] materialized {len(fps)} fingerprints of the schema's shapes")
            del fps, one
        del out, feats
        ms = report_steps(f"{label} composition B={b} x {FULL_SECONDS} s",
                          timed_steps(step, CLASS_STEPS), b * FULL_SECONDS, card)
        profile_step(f"{label} composition", step)
        res["paths"][label] = {"launches": launches, "ms_per_step": ms,
                               "audio_h_per_wall_h": b * FULL_SECONDS / (ms / 1e3),
                               "peak_gib": peak_gib}
    torch.cuda.empty_cache()

    def near(label, x):
        if label == "music":
            pre = pre_emphasis_for_content(dc_removal(x), "music").numpy()
            return parity.near_zero_frames(pre, WINDOW, HOP, 0.0, parity.DC_NEAR_ZERO)
        return parity.near_zero_frames(x.numpy(), WINDOW, HOP, 0.96 if label == "sports" else 0.97)

    def hold(got, ref, label, x, sr, what):
        require(parity.check_extracted(features_to_numpy(got), features_to_numpy(ref), sr, WINDOW,
                                       near_zero=near(label, x), n_samples=x.shape[-1]), what)
        require(parity.check_metadata(got.metadata, ref.metadata), what + ", metadata")

    small = torch.cat([parity.voiced_pcm(1, SR, SEED + 10), parity.harmonic_clips(1, SR, SEED + 11)])
    for label in classes:                                      # phase 31
        on_card = compose(label, small.to(dev))
        hold(on_card, compose(label, small), label, small, SR, f"{label} composition [2, {SR}], card vs CPU")
        if label in ("speech", "music"):
            hold(classes[label].extract_features_from_pcm(small.to(dev), SR), on_card, label, small, SR,
                 f"{label} program against its composition [2, {SR}] on the card")
    clips16 = parity.harmonic_clips(2, 16000, SEED + 8, 16000)
    on_card, on_cpu = compose("music", clips16.to(dev), 16000), compose("music", clips16, 16000)
    hold(on_card, on_cpu, "music", clips16, 16000, "music composition [2, 16000] at 16 kHz, card vs CPU (ZCR exact)")
    zcr = (on_card.spectral_features.zero_crossing_rate.cpu() == on_cpu.spectral_features.zero_crossing_rate)
    log(f"[music composition at 16 kHz] ZCR bit-equal on {int(zcr.sum())} of {zcr.numel()} frames")

    stream = parity.synth_pcm(1, STREAM_SECONDS * SR, SEED + 12, SR)[0].numpy()  # phase 32
    res["streamer"] = {}
    for mode, w, hop, block in (("legacy", WINDOW, HOP, 0), ("block", WINDOW, HOP, STREAM_BLOCK),
                                ("stft_route_4096", 4096, 1024, 0)):
        streamer = STFTStreamer(w, hop, sample_rate=SR, block_frames=block)
        if streamer.route != ("stft" if w > 2048 else "k1"):
            raise AssertionError(f"STFTStreamer {w}/{hop} took the {streamer.route} route")
        whole = stft(torch.from_numpy(stream).to(dev), w, hop, sample_rate=SR).magnitude
        for run in ("checked", "timed"):
            streamer.reset()
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            parts = [streamer.push(stream[i:i + SR]) for i in range(0, len(stream), SR)]
            parts.append(streamer.flush())
            torch.cuda.synchronize()
            ms_per_push = 1e3 * (time.perf_counter() - t0) / (len(parts) - 1)
        mags = [r.magnitude for r in parts if r is not None]
        got = torch.cat(mags)
        if got.shape != whole.shape:
            raise AssertionError(f"STFTStreamer {mode}: {tuple(got.shape)} frames, stft {tuple(whole.shape)}")
        err = float((got - whole).abs().max())
        scale = float(whole.abs().max())
        want_k1 = len(mags) if streamer.route == "k1" else 0
        if block:
            want_k1 = sum(m.shape[0] // block + (m.shape[0] % block > 0) for m in mags)
        log(f"[STFTStreamer {mode} {w}/{hop}, {STREAM_SECONDS} s in 1 s pushes] {got.shape[0]} frames, "
            f"K1 launches {k1.launches}, max |mag - stft| {err:.4g} = {err / scale:.3g} of the largest "
            f"(limit {parity.MAG_ATOL_SCALE}), {ms_per_push:.3f} ms per push [{card}]")
        if k1.launches != want_k1:
            raise AssertionError(f"STFTStreamer {mode}: {k1.launches} K1 launches, expected {want_k1}")
        if not err <= parity.MAG_ATOL_SCALE * scale:
            raise AssertionError(f"STFTStreamer {mode}: magnitudes disagree with stft of the whole signal")
        res["streamer"][mode] = {"window": w, "hop": hop, "block_frames": block, "frames": got.shape[0],
                                 "k1_launches": k1.launches, "max_abs_err": err,
                                 "ms_per_push": ms_per_push}
    res["seconds"] = time.perf_counter() - started
    log(f"phases 30-32 took {res['seconds']:.1f} s")
    return res


ALIGN_SECONDS, ALIGN_BUDGET = 60, 30      # the monitors' defaults: 60 s windows, 30 s budget
FLEET_STREAMS, FLEET_BATCH = 64, 32
# streams whose cdn is an unrelated signal: 8 in each sub-batch of 32, so
# the 0.7 gate fails and the banded DTW runs in both
UNRELATED = tuple(range(24, 32)) + tuple(range(56, 64))
CADENCE_S = 10.0                          # a production monitor's measuring interval
PRESCRIBED_RUN = 3000                     # K8's up and left runs on the prescribed bands


def run_alignment(card: str, dev: torch.device) -> dict:
    """Phases 17-22: the DTW kernels against their plain versions at the
    TPU kernels' geometries, FleetMonitor and LatencyMonitor at full
    width, the card against the CPU, timings and a profile. Returns the
    numbers of the kernels line."""
    from sonido_sonar_tpu_torch import FleetMonitor, LatencyMonitor
    from sonido_sonar_tpu_torch.config.config import FeatureConfig
    from sonido_sonar_tpu_torch.extractors.alignment import AlignmentExtractor
    from sonido_sonar_tpu_torch.ops.stats import hopper_backtrack, hopper_dtw
    from sonido_sonar_tpu_torch.ops.stats.batched_alignment import (
        batched_hybrid_align,
        batched_hybrid_align_device,
    )
    from sonido_sonar_tpu_torch.ops.temporal import short_time_energy
    from sonido_sonar_tpu_torch.utils import parity

    fill, fill_plain = hopper_dtw.fill_banded_hopper, hopper_dtw.fill_banded_plain
    dist, dist_plain = hopper_dtw.local_distances_hopper, hopper_dtw.local_distances_plain
    rows_k = hopper_dtw.fill_rows_hopper
    walk, walk_plain = hopper_backtrack.backtrack_banded_hopper, hopper_backtrack.backtrack_banded_plain
    rng = np.random.default_rng(SEED + 10)
    n_win = ALIGN_SECONDS * SR
    n_chroma = n_win // HOP                          # 10,335: bench.py:303
    band = int(ALIGN_BUDGET * SR) // HOP             # 5,167: the 30 s budget at hop 256
    errs, walk_errs = {}, {}

    def hold_dtw(q, r, band, what):
        n, m = q.shape[1], r.shape[1]
        cost = fill(q, r, band, n, m)
        plain = fill_plain(q, r, band, n, m)
        torch.cuda.synchronize()
        e = require(parity.check_fill(np32(cost), np32(plain)), f"DTW fill vs plain, {what}")
        del plain
        got = walk(cost, band, n, m)
        torch.cuda.synchronize()
        want = walk_plain(cost, band, n, m)
        e.update(require(parity.check_backtrack([np32(t) for t in got], [np32(t) for t in want]),
                             f"DTW backtrack vs plain on the kernel's band, {what}"))
        misses = hopper_backtrack.backtrack_banded_misses(cost, band, n, m)[1]
        log(f"[DTW {what}] path lengths {got[3].tolist()}, K8 misses {misses.tolist()}")
        return e

    def hold_walk(cost, band, n, m, what, pairs, path=None):
        """K8 against the plain walk on `pairs` of `cost`, exactly (equal
        bits), its misses against the numpy model's (utils: walk_model, at
        each pair's offset in the band), the designed path where there is
        one; times the wrapper (CUDA events), warm and with the L2 cache
        flushed, and returns (flushed ms, us per step, misses, errors)."""
        (got, misses), sel = hopper_backtrack.backtrack_banded_misses(cost, band, n, m), pairs
        torch.cuda.synchronize()
        sub = cost if len(sel) == cost.shape[0] else cost[torch.tensor(sel, device=dev)]
        want = walk_plain(sub.contiguous(), band, n, m)
        del sub
        got_s = [np32(t)[sel] for t in got]
        e = require(parity.check_backtrack(got_s, [np32(t) for t in want]),
                    f"DTW backtrack vs plain, {what}")
        if not all(np.array_equal(g.view(np.int32), np32(t).view(np.int32))
                   for g, t in zip(got_s, want)):
            raise AssertionError(f"K8 {what}: outputs not bit-equal to the plain walk")
        model = [hopper_backtrack.walk_model(np32(cost[p]), band, n, m,
                                             offset=hopper_backtrack.band_offset(cost, p))[4]
                 for p in sel]
        if model != np32(misses)[sel].tolist():
            raise AssertionError(f"K8 {what}: misses {np32(misses)[sel].tolist()}, "
                                 f"the model's {model}")
        if path is not None:
            ii, jj = path
            if not (np.array_equal(got_s[0][0, : len(ii)], ii[::-1] - 1)
                    and np.array_equal(got_s[1][0, : len(jj)], jj[::-1] - 1)):
                raise AssertionError(f"K8 {what}: the walk left the designed path")
        counts = walk.launches
        k_ms = cuda_ms(lambda: walk(cost, band, n, m), 3)
        c_ms = cold_ms(lambda: walk(cost, band, n, m), 3)
        walk.launches = counts
        steps = int(got[3].max())
        log(f"[K8 {what}] paths {got_s[3].tolist()}, misses {model} (the model's too), "
            f"{k_ms:.3f} ms warm, {c_ms:.3f} ms with L2 flushed, {1e3 * c_ms / steps:.4f} us per "
            f"step of the longest path (flushed) [{card}]")
        return c_ms, 1e3 * c_ms / steps, np32(misses).tolist(), e

    def hold_dist(q, r, band, what):
        """The fill's distance pre-pass against its plain version."""
        n, m = q.shape[1], r.shape[1]
        got = dist(q, r, band, n, m)
        want = dist_plain(q, r, band, n, m)
        torch.cuda.synchronize()
        return require(parity.check_local_distances(np32(got), np32(want), np32(q), np32(r)),
                       f"DTW distance pre-pass vs plain, {what}")

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)

    # phase 17: the three TPU fills' geometries (K6, K7, K5) and K8 after each
    q6 = rand(8, 2048, 12)
    errs["K6"] = hold_dtw(q6, torch.roll(q6, 5, 1).contiguous(), 64, "K6 [8, 2048, 12] band 64")
    q7 = rand(1, n_chroma, 12)
    errs["K7"] = hold_dtw(q7, torch.roll(q7, 7, 1).contiguous(), band,
                          f"K7 [1, {n_chroma}, 12] band {band}")
    dist_errs = {"K7": hold_dist(q7, torch.roll(q7, 7, 1).contiguous(), band,
                                 f"K7 [1, {n_chroma}, 12] band {band}")}
    lags = rng.integers(int(0.1 * SR), 3 * SR, FLEET_STREAMS)
    src, cdn = parity.alignment_streams(FLEET_STREAMS, ALIGN_SECONDS, SR, lags, SEED + 11,
                                        unrelated=UNRELATED, device=dev)
    e_src = short_time_energy(src, WINDOW, HOP)[..., None].contiguous()
    e_cdn = short_time_energy(cdn, WINDOW, HOP)[..., None].contiguous()
    n_e = e_src.shape[1]
    pairs = [0, UNRELATED[0]]                         # one related pair, one unrelated
    errs["K5"] = hold_dtw(e_src[pairs].contiguous(), e_cdn[pairs].contiguous(), band,
                          f"K5 energies [2, {n_e}, 1] band {band}")
    dist_errs["K5"] = hold_dist(e_src[pairs].contiguous(), e_cdn[pairs].contiguous(), band,
                                f"K5 energies [2, {n_e}, 1] band {band}")
    # a band whose two rows do not fit in shared memory (a 60 s budget at
    # hop 128): the fill keeps its rows in the cost band itself
    wide = int(60 * SR) // 128
    qw, rw = rand(2, 3000, 1), rand(2, 2900, 1)
    errs["wide"] = hold_dtw(qw, rw, wide, f"[2, 3000 x 2900, 1] band {wide}")
    split = {f"[2, 3000 x 2900, 1] band {wide}": time_fill_parts(qw, rw, wide, card)}
    del q6, q7, qw, rw
    torch.cuda.empty_cache()

    # phase 17b: K8 on prescribed-path bands built on the card, n = m =
    # 10,332: 3,000-step up and left runs (and at band 5,167 a left run to
    # k = 0 and an up run back), at the fleet's band and the wide band
    n_p, run, gap = n_chroma - 3, PRESCRIBED_RUN, PRESCRIBED_RUN // 15
    for pband, runs in (
        (band, [("D", gap // 2), ("U", run), ("D", gap), ("L", run), ("D", gap), ("L", band),
                ("D", gap), ("U", band), ("D", n_p - run - band - gap // 2 - 3 * gap)]),
        (wide, [("D", gap // 2), ("U", run), ("D", gap), ("L", run),
                ("D", n_p - run - gap // 2 - gap)]),
    ):
        cost_p, ii, jj = parity.prescribed_path_band(runs, pband, SEED + 13, device=dev)
        kk = jj - ii + pband
        what = f"prescribed path [1, {n_p}] band {pband}, k {kk.min()}..{kk.max()}"
        walk_errs[f"prescribed {pband}"] = hold_walk(cost_p[None], pband, n_p, n_p, what, [0],
                                                     (ii, jj))[3]
        del cost_p
        torch.cuda.empty_cache()

    # phase 18: FleetMonitor at full width (the slice's main path)
    fcfg = FeatureConfig(sample_rate=SR, window_size=WINDOW, hop_size=HOP)
    fleet = FleetMonitor(fcfg, n_streams=FLEET_STREAMS, window_seconds=ALIGN_SECONDS,
                         max_lag_seconds=ALIGN_BUDGET, measure_batch=FLEET_BATCH, device=dev)
    fleet.push_source_all(src)
    fleet.push_cdn_all(cdn)
    # both sides' pushes of a whole window: card tensors (a device copy)
    # and numpy (staged through pinned memory); the same samples again, so
    # the windows must not change
    src_np, cdn_np = src.cpu().numpy(), cdn.cpu().numpy()
    kept = (fleet._src.buf.clone(), fleet._cdn.buf.clone())
    push_ms = {}
    for label, (ps, pc) in (("card tensors", (src, cdn)), ("numpy", (src_np, cdn_np))):
        steps = timed_steps(lambda: (fleet.push_source_all(ps), fleet.push_cdn_all(pc)), 4)[1:]
        push_ms[label] = 1e3 * float(np.median(steps))
    if not (torch.equal(fleet._src.buf, kept[0]) and torch.equal(fleet._cdn.buf, kept[1])):
        raise AssertionError("fleet: a numpy push of the same samples changed the windows")
    del kept
    log(f"fleet pushes of both sides, {FLEET_STREAMS} x {ALIGN_SECONDS} s each: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in push_ms.items())
        + f" (median of 3 after one warm push) [{card}]")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fill.launches = walk.launches = 0
    res = fleet.measure_all(refine=True)
    torch.cuda.synchronize()
    launches = {"fill": fill.launches, "backtrack": walk.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"fleet measure_all launches: {launches}")
    if launches["fill"] < 2 or launches["backtrack"] < 2:
        raise AssertionError(f"the fleet did not run the DTW kernels in both sub-batches: {launches}")
    related = [i for i in range(FLEET_STREAMS) if i not in UNRELATED]
    off = np.array([abs(res[i].latency_s - lags[i] / SR) for i in related])
    methods = {}
    for m in res:
        methods[m.method] = methods.get(m.method, 0) + 1
    log(f"[fleet] {len(related)} related streams: max |latency - injected lag| "
        f"{off.max() * 1e3:.3f} ms (one hop is {1e3 * HOP / SR:.3f} ms); methods {methods}; "
        f"confidence related min {min(res[i].confidence for i in related):.3f}, unrelated max "
        f"{max(res[i].confidence for i in UNRELATED):.3f}")
    if not (off <= HOP / SR).all():
        bad = [related[k] for k in np.nonzero(off > HOP / SR)[0]]
        raise AssertionError(f"fleet: streams {bad} beyond one hop of their lag")
    if not all(np.isfinite([m.latency_s, m.confidence, m.similarity]).all() for m in res):
        raise AssertionError("fleet: non-finite measurements")
    step_s = timed_steps(lambda: fleet.measure_all(refine=True), 3)
    fleet_ms = 1e3 * float(np.median(step_s))
    log(f"fleet measure_all {FLEET_STREAMS} x {ALIGN_SECONDS} s ({ALIGN_BUDGET} s budget, refine): "
        f"{fleet_ms:.2f} ms median of 3 ({', '.join(f'{1e3 * s:.2f}' for s in step_s)}); "
        f"{FLEET_STREAMS * CADENCE_S / (fleet_ms / 1e3):.0f} streams per card at a "
        f"{CADENCE_S:.0f} s cadence; peak device memory {peak_gib:.2f} GiB [{card}]")

    # phase 19: LatencyMonitor at B = 1, one measure through the gate, one past it
    mon_ms = {}
    passing = [i for i in related if res[i].method.startswith("energy_correlation")]
    failing = [i for i in UNRELATED if not res[i].method.startswith("energy_correlation")]
    if not passing or not failing:
        raise AssertionError(f"fleet: no stream on each side of the 0.7 gate ({methods})")
    for label, row in (("gate passes", passing[0]), ("gate fails", failing[0])):
        mon = LatencyMonitor(fcfg, window_seconds=ALIGN_SECONDS, max_lag_seconds=ALIGN_BUDGET,
                             device=dev)
        mon.push_source(src[row])
        mon.push_cdn(cdn[row])
        steps = timed_steps(lambda: (mon.push_source(src_np[row]), mon.push_cdn(cdn_np[row])), 4)[1:]
        mon_ms[f"{label}, numpy pushes"] = 1e3 * float(np.median(steps))
        if not torch.equal(mon._src.buf, src[row]) or not torch.equal(mon._cdn.buf, cdn[row]):
            raise AssertionError(f"LatencyMonitor ({label}): numpy pushes changed the windows")
        fill.launches = 0
        m = mon.measure(refine=True)
        steps = timed_steps(lambda: mon.measure(refine=True), 3)
        mon_ms[label] = 1e3 * float(np.median(steps))
        truth = ("the cdn is unrelated to the source" if row in UNRELATED
                 else f"injected {lags[row] / SR:+.5f} s")
        log(f"[LatencyMonitor, {label}] {m.method}, latency {m.latency_s:+.5f} s ({truth}), "
            f"confidence {m.confidence:.3f}, fill launches "
            f"{fill.launches}; {mon_ms[label]:.2f} ms per measure(); both sides' numpy "
            f"pushes of {ALIGN_SECONDS} s {mon_ms[f'{label}, numpy pushes']:.2f} ms [{card}]")
        if (row in UNRELATED) != (fill.launches > 0) or m.method != res[row].method:
            raise AssertionError(f"LatencyMonitor ({label}): {m.method}, the fill ran "
                                 f"{fill.launches} times; the fleet measured {res[row].method}")
        if row not in UNRELATED and abs(m.latency_s - lags[row] / SR) > HOP / SR:
            raise AssertionError(f"LatencyMonitor: latency {m.latency_s} for lag {lags[row] / SR}")

    # phase 20: card against CPU at a small size
    small_lags = [int(0.3 * SR), -int(0.45 * SR), int(1.1 * SR), 0]
    s_src, s_cdn = parity.alignment_streams(4, 12, SR, small_lags, SEED + 12, unrelated=(3,))
    kw = dict(n_streams=4, window_seconds=12.0, max_lag_seconds=3.0, measure_batch=4)
    per_device = []
    for d in (dev, torch.device("cpu")):
        f = FleetMonitor(fcfg, device=d, **kw)
        f.push_source_all(s_src)
        f.push_cdn_all(s_cdn)
        ext = AlignmentExtractor(fcfg, max_lag_seconds=2.0)
        a = ext.align_audio_files(s_src[0, : 5 * SR].to(d), s_cdn[0, : 5 * SR].to(d), SR)
        per_device.append((f.measure_all(refine=True), a))
    (card_res, card_a), (cpu_res, cpu_a) = per_device
    worst = 0.0
    for i, (c, h) in enumerate(zip(card_res, cpu_res)):
        if c.method != h.method or abs(c.latency_s - h.latency_s) > 1e-6:
            raise AssertionError(f"fleet card vs CPU, stream {i}: {c} != {h}")
        worst = max(worst, abs(c.confidence - h.confidence), abs(c.similarity - h.similarity))
    for key in ("offset_confidence", "alignment_similarity", "alignment_quality"):
        worst = max(worst, abs(getattr(card_a, key) - getattr(cpu_a, key)))
    if card_a.temporal_offset != cpu_a.temporal_offset or card_a.method != cpu_a.method:
        raise AssertionError(f"align_audio_files card vs CPU: {card_a.temporal_offset} "
                             f"!= {cpu_a.temporal_offset}")
    if worst > parity.ALIGN_SCORE_ATOL:
        raise AssertionError(f"alignment card vs CPU: scores differ by {worst:.3g}")
    log(f"[alignment card vs CPU] 4-stream fleet (12 s, 3 s budget; methods "
        f"{[m.method for m in card_res]}) and align_audio_files: offsets and methods equal, "
        f"scores within {worst:.2e}")

    # phase 21: kernel and plain timings (CUDA events), fleet geometry
    times = {}
    qe, re_ = e_src[pairs].contiguous(), e_cdn[pairs].contiguous()
    cost2 = fill(qe, re_, band, n_e, n_e)
    for name, kern, plain, args in (
        ("fill", fill, fill_plain, (qe, re_, band, n_e, n_e)),
        ("backtrack", walk, walk_plain, (cost2, band, n_e, n_e)),
    ):
        # no warm-up: the plain fill at this size takes seconds
        times[name] = in_turns(lambda: kern(*args), lambda: plain(*args), 3, warm=False)
        log(f"DTW {name} at B=2, n={n_e}, band {band}: kernel {times[name][0]:.3f} ms, "
            f"plain {times[name][1]:.1f} ms [{card}]")
    # bounds at the timed geometry: the fill writes the whole band (a local
    # distance, a three-way min and an add per cell, d = 1); the walk reads
    # three neighbours and writes (q, r, cost) at each step of its paths
    cells = 2 * (n_e + 1) * (2 * band + 1)
    bounds = {"fill": bound(qe.numel() * 8 + cells * 4, cells * 8)}
    steps = int(walk(cost2, band, n_e, n_e)[3].sum())
    bounds["backtrack"] = bound(steps * 24 + 2 * 4, steps * 6)
    walk2 = hold_walk(cost2, band, n_e, n_e, f"B=2, [2, {n_e}, 1] band {band}", [0, 1])
    walk2_steps = int(walk(cost2, band, n_e, n_e)[3].max())
    del cost2
    split[f"B=2, [2, {n_e}, 1] band {band}"] = time_fill_parts(qe, re_, band, card)
    q32, r32 = e_src[:FLEET_BATCH].contiguous(), e_cdn[:FLEET_BATCH].contiguous()
    split[f"B={FLEET_BATCH}, [{FLEET_BATCH}, {n_e}, 1] band {band}"] = time_fill_parts(
        q32, r32, band, card)
    cost32 = fill(q32, r32, band, n_e, n_e)
    w32 = cuda_ms(lambda: walk(cost32, band, n_e, n_e), 3)
    log(f"DTW at B={FLEET_BATCH} (one fleet sub-batch, band {band}): backtrack {w32:.2f} ms, "
        f"cost band {cost32.numel() * 4 / 1e9:.2f} GB [{card}]")
    times["backtrack_b32"] = w32
    times["backtrack_b2_cold"] = walk2[0]
    times["fill_b32"] = split[f"B={FLEET_BATCH}, [{FLEET_BATCH}, {n_e}, 1] band {band}"]["whole_ms"]
    # the sub-batch the fleet sends, checked: from pair 21 on a pair's
    # offset in the band passes 2^31 elements; pair 24 is unrelated (its
    # answer is the DTW's)
    rows = [0, UNRELATED[0], FLEET_BATCH - 1]
    sel = torch.tensor(rows, device=dev)
    plain = fill_plain(q32[sel].contiguous(), r32[sel].contiguous(), band, n_e, n_e)
    e32 = require(parity.check_fill(np32(cost32[sel]), np32(plain)),
                  f"DTW fill vs plain, pairs {rows} of [{FLEET_BATCH}, {n_e}, 1] band {band}")
    del plain
    got = walk(cost32, band, n_e, n_e)
    torch.cuda.synchronize()
    walk32 = hold_walk(cost32, band, n_e, n_e, f"pairs {rows} of the B={FLEET_BATCH} band", rows)
    e32.update(walk32[3])
    times["backtrack_b32_cold"] = walk32[0]
    errs[f"K5 B={FLEET_BATCH}"] = e32
    log(f"[DTW B={FLEET_BATCH}] pairs {rows} held to plain: fill max rel "
        f"{e32['fill_max_rel']:.3g}, path lengths {got[3][sel].tolist()}; K8 misses per pair "
        f"{walk32[2]} (mean {np.mean(walk32[2]):.1f}), {1e3 * w32 / int(got[3].max()):.4f} us "
        f"per step of the longest path (warm)")
    # the walk's chain floor: its longest path's steps, one shared-memory
    # round trip each (SMEM_ROUND_TRIP cycles) at the card's top SM clock
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True, timeout=60).stdout.split()[0])
    floor_ms = walk2_steps * SMEM_ROUND_TRIP / (mhz * 1e3)
    log(f"K8 chain floor at B=2: {walk2_steps} steps x {SMEM_ROUND_TRIP} cycles at {mhz:.0f} MHz "
        f"= {floor_ms:.3f} ms (kernel {times['backtrack'][0]:.3f} ms) [{card}]")
    log("K8 ring: " + json.dumps({"B2_cold_ms": walk2[0], "B2_us_per_step": walk2[1],
                                  "B2_misses": walk2[2], "B32_ms": w32,
                                  "B32_cold_ms": times["backtrack_b32_cold"],
                                  "B32_misses": walk32[2], "B2_chain_floor_ms": floor_ms}))
    del cost32, q32, r32, got
    torch.cuda.empty_cache()

    # the hybrid's host reads, counted by CUDA's sync debug mode: one (the
    # gate vector) for batched_hybrid_align, none for the _device variant
    e2 = (e_src[pairs, :, 0].contiguous(), e_cdn[pairs, :, 0].contiguous())
    max_lag = int(ALIGN_BUDGET * SR) // HOP
    syncs = {}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for name, fn in (("device", batched_hybrid_align_device), ("gated", batched_hybrid_align)):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                hyb = fn(*e2, max_lag, HOP, SR)
                hyb = {k: v for k, v in hyb.items() if k != "topk_lags"}
            syncs[name] = (sum("synchroniz" in str(w.message) for w in caught), hyb)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    dev_out, gated_out = syncs["device"][1], syncs["gated"][1]
    log(f"[hybrid host reads] batched_hybrid_align_device {syncs['device'][0]}, "
        f"batched_hybrid_align {syncs['gated'][0]}; methods {gated_out['method'].tolist()}")
    if syncs["device"][0] != 0 or syncs["gated"][0] != 1:
        raise AssertionError(f"hybrid host reads: device {syncs['device'][0]} (expected 0), "
                             f"gated {syncs['gated'][0]} (expected 1)")
    if not (torch.equal(dev_out["offset_samples"], gated_out["offset_samples"])
            and torch.equal(dev_out["method"], gated_out["method"])):
        raise AssertionError("batched_hybrid_align_device and batched_hybrid_align differ")

    profile_step("fleet measure_all", lambda: fleet.measure_all(refine=True))  # phase 22
    fill_err = max(e["fill_max_abs"] for e in errs.values())
    walk_err = max(e["path_cost"] for e in (*errs.values(), *walk_errs.values()))
    log("DTW fill parts: " + json.dumps({"split": split, "prepass_vs_plain": dist_errs}))
    return {"launches": launches, "times": times, "fill_err": fill_err, "walk_err": walk_err,
            "fleet_ms": fleet_ms, "bounds": bounds}


def time_fill_parts(q: torch.Tensor, r: torch.Tensor, band: int, card: str) -> dict:
    """The fill's two kernels and the whole wrapper call, timed apart
    (CUDA events, after one warm-up call each): the distance pre-pass,
    the row recurrence (in place over the band, whose work does not
    depend on the values it holds) and fill_banded_hopper; us per row of
    the recurrence; each time beside its bytes bound (the pre-pass writes
    the band, the recurrence reads and writes it again). Wrapper calls
    made here leave the launch counts as they were."""
    from sonido_sonar_tpu_torch.ops.stats import hopper_dtw

    fns = (hopper_dtw.local_distances_hopper, hopper_dtw.fill_rows_hopper,
           hopper_dtw.fill_banded_hopper)
    counts = [f.launches for f in fns]
    b, n, m = q.shape[0], q.shape[1], r.shape[1]
    band_bytes = b * (n + 1) * (2 * band + 1) * 4
    cost = hopper_dtw.local_distances_hopper(q, r, band, n, m)
    out = {}
    for name, fn, nbytes in (
        ("prepass", lambda: hopper_dtw.local_distances_hopper(q, r, band, n, m),
         q.numel() * 4 + r.numel() * 4 + band_bytes),
        ("rows", lambda: hopper_dtw.fill_rows_hopper(cost, band, n, m), 2 * band_bytes),
        ("whole", lambda: hopper_dtw.fill_banded_hopper(q, r, band, n, m),
         q.numel() * 4 + r.numel() * 4 + band_bytes),
    ):
        fn()
        out[f"{name}_ms"] = cuda_ms(fn, 2)
        out[f"{name}_bound_ms"] = bound(nbytes, 0)[0]
    out["rows_us_per_row"] = 1e3 * out["rows_ms"] / n
    for f, c in zip(fns, counts):
        f.launches = c
    log(f"DTW fill at [{b}, {n} x {m}, {q.shape[2]}] band {band}: pre-pass "
        f"{out['prepass_ms']:.3f} ms (bound {out['prepass_bound_ms']:.3f}), recurrence "
        f"{out['rows_ms']:.3f} ms (bound {out['rows_bound_ms']:.3f}; "
        f"{out['rows_us_per_row']:.3f} us per row), whole call {out['whole_ms']:.3f} ms "
        f"(bound {out['whole_bound_ms']:.3f}) [{card}]")
    return out


def run_features(card: str, dev: torch.device, full: torch.Tensor, small: torch.Tensor) -> dict:
    """Phases 23-27: K10, the main path's feature-epilogue configuration,
    K9 and K3. Returns the numbers of their kernels-line entries and the
    two configurations' step times."""
    from sonido_sonar_tpu_torch.config.config import WindowType
    from sonido_sonar_tpu_torch.ops import hopper_contrast, hopper_stft, hopper_yin
    from sonido_sonar_tpu_torch.ops.filters import pre_emphasis
    from sonido_sonar_tpu_torch.ops.spectral import contrast_band_edges
    from sonido_sonar_tpu_torch.ops.tables import device_table
    from sonido_sonar_tpu_torch.ops.windows import make_window
    from sonido_sonar_tpu_torch.parallel import pipeline
    from sonido_sonar_tpu_torch.utils import parity

    k1, k1_plain = hopper_stft.stft_magnitude_hopper, hopper_stft.stft_magnitude_plain
    k9, k9_plain = hopper_contrast.band_select_means_hopper, hopper_contrast.band_select_means_plain
    k3, k3_plain = hopper_yin.yin_difference_hopper, hopper_yin.yin_difference_plain
    feat_kw = dict(pre_emph=PRE_EMPH, with_features=True, sample_rate=SR)
    res = {}

    def hold_k10(x, across_dfts: bool, w=WINDOW, hop=HOP, sr=SR):      # phase 23
        """The epilogue against its plain version on the kernel's own
        magnitudes (K1's are held to their plain version in phase 4 and
        must equal the launch without features), and two launches
        bit-equal (no atomics: the partial sums' order is fixed); with
        `across_dfts`, the whole plain version too. Flatness and slope
        take logs of every bin above 1e-10, so across two DFTs a frame's
        few smallest bins move them: at 128 x 30 s one frame in 661k
        missed the whole-path bound of utils/parity (flatness 0.2244
        against 0.2171), so the whole plain version is held at the small
        sizes only."""
        what = f"K10 vs plain, {tuple(x.shape)}, {w}/{hop} at {sr} Hz"
        kw = dict(pre_emph=PRE_EMPH, with_features=True, sample_rate=sr)
        mag, aux, feat = k1(x, w, hop, **kw)
        mag0, aux0 = k1(x, w, hop, pre_emph=PRE_EMPH)
        again = k1(x, w, hop, **kw)[2]
        torch.cuda.synchronize()
        if not (torch.equal(mag, mag0) and all(torch.equal(aux[k], aux0[k]) for k in aux0)):
            raise AssertionError(f"{what}: magnitudes or aux differ from the launch without features")
        if not torch.equal(feat, again):
            raise AssertionError(f"{what}: two launches gave different feat bits")
        del again
        same = hopper_stft.frame_features(mag, sr, w)
        e = require(parity.check_feat(np32(feat), np32(same), same_magnitudes=True),
                    what + ", on the kernel's magnitudes")
        del same
        if across_dfts:
            pfeat = k1_plain(x, w, hop, **kw)[2]
            require(parity.check_feat(np32(feat), np32(pfeat), same_magnitudes=False),
                    what + ", across the two DFTs")
        log(f"[{what}] magnitudes and aux bit-equal to the launch without features, "
            f"feat bit-equal between two launches")
        return e

    hold_k10(small, across_dfts=True)
    for w, hop, sr in ((64, 16, SR), (256, 100, 16000), (1024, 255, SR), (2048, 512, SR)):
        hold_k10(parity.synth_pcm(3, sr + 777, SEED + 3, sr, dev), True, w, hop, sr)
    res["K10_err"] = max(hold_k10(full, across_dfts=False).values())
    torch.cuda.empty_cache()

    # phase 24: the feature-epilogue configuration of the main path
    t_frames = (full.shape[-1] - WINDOW) // HOP + 1
    k1.launches = k1.feat_launches = 0
    default = pipeline.batched_fingerprint_features(full, SR, WINDOW, HOP)
    torch.cuda.synchronize()
    if k1.feat_launches != 0 or k1.launches != 1:
        raise AssertionError(f"the default configuration launched K1 {k1.launches} times, "
                             f"{k1.feat_launches} with features")
    os.environ[pipeline.FEAT_EPILOGUE_ENV] = "1"
    try:
        k1.launches = k1.feat_launches = 0
        hopper_yin.yin_pitch_hopper.launches = k9.launches = 0
        out = pipeline.batched_fingerprint_features(full, SR, WINDOW, HOP)
        torch.cuda.synchronize()
        res["feat_launches"] = {"K1": k1.launches, "K10": k1.feat_launches,
                                "K2": hopper_yin.yin_pitch_hopper.launches, "K9": k9.launches}
        log(f"feature-epilogue main path launches: {res['feat_launches']}")
        if res["feat_launches"] != {"K1": 1, "K10": 1, "K2": 1, "K9": 1}:
            raise AssertionError(f"the feature-epilogue configuration launched {res['feat_launches']}")
        if list(out) != list(default):
            raise AssertionError(f"keys {list(out)}, expected {list(default)}")
        for key, v in out.items():
            want = default[key]
            if v.shape != want.shape or v.dtype != want.dtype or not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{key}: {v.dtype}{tuple(v.shape)} (finite "
                                     f"{bool(torch.isfinite(v).all())}), expected "
                                     f"{want.dtype}{tuple(want.shape)}")
        require(parity.check_features({k: np32(v) for k, v in out.items()},
                                      {k: np32(v) for k, v in default.items()},
                                      np.zeros((full.shape[0], t_frames), bool), SR, WINDOW),
                f"main path B={full.shape[0]}: feature-epilogue against default configuration")
        del out, default

        def step(flag: str):
            os.environ[pipeline.FEAT_EPILOGUE_ENV] = flag
            return timed_steps(lambda: pipeline.batched_fingerprint_features(full, SR, WINDOW, HOP),
                               TIMED_STEPS)

        runs = {"default": [], "feat": []}
        for name, flag in (("default", ""), ("feat", "1"), ("feat", "1"), ("default", "")):
            runs[name] += step(flag)
        for name, steps in runs.items():
            res[f"step_ms_{name}"] = 1e3 * float(np.mean(steps))
            log(f"main path ({name} configuration) B={full.shape[0]} x {FULL_SECONDS} s: "
                f"{res[f'step_ms_{name}']:.2f} ms/step (steps "
                f"{', '.join(f'{1e3 * t:.2f}' for t in steps)}) [{card}]")
        os.environ[pipeline.FEAT_EPILOGUE_ENV] = "1"
        pcm2 = parity.synth_pcm(2, SR, SEED + 2, SR)
        on_card = pipeline.batched_fingerprint_features(pcm2.to(dev))
        on_cpu = pipeline.batched_fingerprint_features(pcm2)
        require(parity.check_features(
            {k: np32(v) for k, v in on_card.items()}, {k: v.numpy() for k, v in on_cpu.items()},
            parity.near_zero_frames(pcm2.numpy(), WINDOW, HOP, PRE_EMPH), SR, WINDOW,
        ), "feature-epilogue main path [2, 44100], card vs CPU")
    finally:
        del os.environ[pipeline.FEAT_EPILOGUE_ENV]
    torch.cuda.empty_cache()

    # phase 25: K9 at the main path's magnitudes, held to its plain version
    mag = k1(full, WINDOW, HOP, pre_emph=PRE_EMPH)[0]
    edges = contrast_band_edges(6, mag.shape[-1], SR)
    peak, valley = k9(mag, edges)
    torch.cuda.synchronize()
    ppeak, pvalley = k9_plain(mag, edges)
    e9 = require(parity.check_band_means(np32(peak), np32(valley), np32(ppeak), np32(pvalley)),
                 f"K9 vs plain, {tuple(mag.shape)}, edges {edges}")
    res["K9_err"] = max(e9.values())
    tie = torch.zeros((1, 16, mag.shape[-1]), device=dev)
    tie[0, :, edges[3]:edges[4]] = 0.25
    tpeak, tvalley = k9(tie, edges)
    others = [0, 1, 2, 4, 5]
    if not (bool((tpeak[0, :, 3] == 0.0625).all()) and bool((tvalley[0, :, 3] == 0.0625).all())
            and not bool(tpeak[0, :, others].any()) and not bool(tvalley[0, :, others].any())):
        raise AssertionError("K9: the constant band or the zero bands are not exact")
    log("[K9] the tie and zero case exact")
    again = k9(mag, edges)
    if not (torch.equal(peak, again[0]) and torch.equal(valley, again[1])):
        raise AssertionError("K9: two launches gave different bits")
    del again
    log("[K9] two launches bit-equal")

    def hold_k9(m, e, what):
        """K9 against its plain version on the card and, where band_plan
        gives a lane plan, against the numpy model of the plan on the
        first 4,096 frames (the gate is parity's; bit-equal elements are
        counted: where the kernel ran the plan, the two sum in one
        order)."""
        got = k9(m, e)
        ref = k9_plain(m, e)
        again = k9(m, e)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"K9 {what}: two launches gave different bits")
        require(parity.check_band_means(*(np32(t) for t in (*got, *ref))),
                f"K9 vs plain, {what} {tuple(m.shape)}, edges {e}")
        keys = hopper_contrast.band_plan(tuple(e), m.shape[-1])[1]
        if keys:
            sub = np32(m.reshape(-1, m.shape[-1])[:4096])
            mp, mv = hopper_contrast.band_means_model(sub, e)[:2]
            kp, kv = (np32(t.reshape(-1, t.shape[-1])[:4096]) for t in got)
            require(parity.check_band_means(kp, kv, mp, mv), f"K9 vs its numpy model, {what}")
            log(f"[K9 {what}] a plan of {keys} keys a lane: {int((kp == mp).sum() + (kv == mv).sum())}"
                f" of {kp.size + kv.size} means bit-equal to the model")
        else:
            log(f"[K9 {what}] no lane plan: the general form")

    # the model's hazards at full size: ties at the k-th key, zero and
    # subnormal powers, a constant band, degenerate bands, W = 2048, the
    # 22.05 kHz edges; and the general form at W = 4096
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    haz = torch.randn(mag.shape, generator=gen, device=dev).abs_()
    hold_k9(torch.round(haz * 2) / 2, edges, "ties")
    haz[::3] = 0.0
    haz[1::3] *= 1e-21
    hold_k9(haz, edges, "zero and subnormal powers")
    haz.zero_()
    haz[..., 20:300] = 0.5
    hold_k9(haz, edges, "one constant band")
    del haz
    hold_k9(mag, (0, 4, 4, 10, 600), "degenerate and clipped bands")
    hold_k9(mag, contrast_band_edges(6, mag.shape[-1], 22050), "22.05 kHz edges")
    m_big = k1(full, 2048, 1024, pre_emph=PRE_EMPH)[0]
    hold_k9(m_big, contrast_band_edges(6, m_big.shape[-1], SR), "W = 2048")
    m_big = torch.randn((FULL_B, 645, 2049), generator=gen, device=dev).abs_()
    hold_k9(m_big, contrast_band_edges(6, 2049, SR), "W = 4096 (random magnitudes, the general form)")
    del m_big
    torch.cuda.empty_cache()
    t9 = in_turns(lambda: k9(mag, edges), lambda: k9_plain(mag, edges), 10)
    res["K9_times"] = t9
    in_bands = edges[-1] - edges[0]
    frames = mag.numel() // mag.shape[-1]
    # a linear-time selection of the top and the bottom k: a compare and
    # an add per element for each, over the band's bins
    res["K9_bound"] = bound(mag.numel() * 4 + 2 * frames * 6 * 4, frames * in_bands * 4)
    res["K9_shape"] = tuple(mag.shape)
    del peak, valley, ppeak, pvalley

    # phase 27 (K10, K1 and K1 against torch.stft) while the magnitudes' input is here
    res["K10_times"] = in_turns(lambda: k1(full, WINDOW, HOP, **feat_kw),
                                lambda: k1_plain(full, WINDOW, HOP, **feat_kw), 10)
    k10_ms, k1_ms = in_turns(lambda: k1(full, WINDOW, HOP, **feat_kw),
                             lambda: k1(full, WINDOW, HOP, pre_emph=PRE_EMPH), 30)
    log(f"K10 {k10_ms:.4f} ms, K1 {k1_ms:.4f} ms in turns (K1, K10, K10, K1): the feature "
        f"epilogue {k10_ms - k1_ms:.4f} ms at {tuple(full.shape)}, {WINDOW}/{HOP} [{card}]")
    xp = pre_emphasis(full, PRE_EMPH)
    hann = device_table(make_window, (WindowType.HANN, WINDOW), dev)

    def library_stft():
        return torch.stft(xp, WINDOW, HOP, window=hann, center=False, return_complex=True).abs()

    lib = library_stft()
    if lib.shape != (full.shape[0], mag.shape[-1], mag.shape[-2]):
        raise AssertionError(f"torch.stft gave {tuple(lib.shape)}")
    lib_err = float((lib.transpose(-1, -2) - mag).abs().max() / mag.abs().max())
    del lib
    res["K1_library_ms"] = cuda_ms(library_stft, 10)
    log(f"torch.stft(center=False).abs() at {tuple(full.shape)}: {res['K1_library_ms']:.3f} ms, "
        f"max |difference| from K1 {lib_err:.2e} of the largest magnitude [{card}]")
    del xp, mag
    torch.cuda.empty_cache()

    # phase 26: K3 at B=128 x 30 s, 1024/512, its op driven once, then held
    k3.launches = 0
    res["K3_err"], shape3 = hold_k3(full, PITCH_WINDOW, PITCH_HOP)
    res["K3_launches"] = k3.launches
    frames3 = shape3[0] * shape3[1]
    res["K3_bound"] = bound(full.numel() * 4 + frames3 * shape3[2] * 4,
                            frames3 * yin_ops(PITCH_WINDOW))
    res["K3_shape"] = shape3
    torch.cuda.empty_cache()
    res["K3_times"] = in_turns(lambda: k3(full, PITCH_WINDOW, PITCH_HOP),
                               lambda: k3_plain(full, PITCH_WINDOW, PITCH_HOP), 10)
    for name in ("K10", "K9", "K3"):
        q, p_ = res[f"{name}_times"]
        log(f"{name}: kernel {q:.3f} ms, plain {p_:.3f} ms [{card}]")
    torch.cuda.empty_cache()
    return res


CORPUS_ROWS = 262_144                     # bench.py:585-595's corpus
CORPUS_DUPLICATES = 64                    # rows made copies of one row, so scores tie
SEARCH_QUERIES = 4                        # phase 28's queries from the batch
MULTI_QUERIES, TOP_K = 64, 16


def _same_ranking(what: str, ids: list, sims: list, ref_ids: list, ref_sims: list) -> int:
    """A ranking (`ids`, descending `sims`) equal to a reference ranking
    that may run longer: the similarities within utils/parity
    .COMPARATOR_HOST_ATOL, the ids equal. Where reference similarities
    lie within that bound of each other, a float32 sum in another order
    may swap them, so such a run is compared as a set (a subset where the
    cut falls inside it). Returns the number of such runs."""
    from sonido_sonar_tpu_torch.utils import parity

    tol, n = parity.COMPARATOR_HOST_ATOL, len(ids)
    if len(ref_ids) < n:
        raise AssertionError(f"{what}: {n} rows, the reference has {len(ref_ids)}")
    err = float(np.abs(np.asarray(sims) - np.asarray(ref_sims[:n])).max(initial=0.0))
    if err > tol:
        raise AssertionError(f"{what}: similarities differ by {err:.3g} > {tol}")
    runs, start = 0, 0
    for i in range(1, len(ref_ids) + 1):
        if start >= n:
            break
        if i < len(ref_ids) and ref_sims[i - 1] - ref_sims[i] <= tol:
            continue
        part, ref = ids[start:min(i, n)], ref_ids[start:i]
        if not (sorted(part) == sorted(ref) if i <= n else set(part) <= set(ref)):
            raise AssertionError(f"{what}: rows {start}-{min(i, n) - 1} hold {part}, "
                                 f"the reference {ref}")
        runs += i - start > 1
        start = i
    return runs


def run_comparator(card: str, dev: torch.device, batch, fps, gen_step, kernels: dict) -> dict:
    """Phases 28-29: the comparator from phase 12's batch at full width,
    then at corpus scale. Returns the numbers of the comparator line."""
    from sonido_sonar_tpu_torch.config.config import ComparisonConfig, ContentType
    from sonido_sonar_tpu_torch.fingerprint import device_compare as DC
    from sonido_sonar_tpu_torch.fingerprint.comparison import FingerprintComparator
    from sonido_sonar_tpu_torch.fingerprint.generator import AudioFingerprint
    from sonido_sonar_tpu_torch.utils import parity

    t_start = time.perf_counter()
    res = {"card": card}
    # phase 28: the batch's packed matrix, on the card, against the host packer
    m = batch.comparator_matrix(13)
    torch.cuda.synchronize()
    if tuple(m.shape) != (FULL_B, DC.layout_size(13)) or m.dtype != torch.float32 or not m.is_cuda:
        raise AssertionError(f"comparator_matrix: {tuple(m.shape)} {m.dtype} on {m.device}")
    if not bool(torch.isfinite(m).all()):
        raise AssertionError("comparator_matrix: non-finite values")
    host, _ = DC.comparator_matrix(fps, 13)
    scale = np.maximum(np.abs(host), 1.0)
    res["pack_scaled_err"] = float((np.abs(np32(m) - host) / scale).max())
    log(f"[comparator_matrix {tuple(m.shape)} on the card vs the host packer] max scaled |diff| "
        f"{res['pack_scaled_err']:.3g} (limit {parity.COMPARATOR_PACK_SCALED_ATOL})")
    if not res["pack_scaled_err"] <= parity.COMPARATOR_PACK_SCALED_ATOL:
        raise AssertionError("the batch's packed matrix disagrees with the host packer")
    packed = DC.PackedCorpus.from_batch(batch, 13)
    built = DC.PackedCorpus.build(fps, 13, device=dev)
    if not torch.equal(packed.codes, built.codes) or packed.codes.dtype != torch.int32:
        raise AssertionError("PackedCorpus.from_batch and .build give other content codes")

    def pack_step():
        return gen_step().comparator_matrix(13)

    k1, k2 = kernels["K1"], kernels["K2"]
    k1.launches = k2.launches = k2.amp_launches = 0
    pack_step()
    torch.cuda.synchronize()
    res["launches"] = {"K1": k1.launches, "K2": k2.launches, "K2amp": k2.amp_launches}
    log(f"generate + pack launches: {res['launches']}")
    if res["launches"]["K1"] < 1 or res["launches"]["K2"] < 2 or res["launches"]["K2amp"] < 1:
        raise AssertionError(f"the generate + pack path missed a kernel: {res['launches']}")
    step_s = timed_steps(pack_step, SURFACE_STEPS)
    res["generate_pack_ms"] = report_steps(f"generate + pack B={FULL_B} x {FULL_SECONDS} s", step_s,
                                           FULL_B * FULL_SECONDS, card)
    res["generate_pack_audio_h_per_h"] = FULL_B * FULL_SECONDS / float(np.mean(step_s))
    comp = FingerprintComparator(ComparisonConfig(similarity_threshold=0.0), device=dev)
    on_cpu = DC.PackedCorpus(packed.fingerprints, packed.matrix.cpu(), packed.codes.cpu(), 13)
    res["search_tied_runs"] = 0
    for qi in np.linspace(0, FULL_B - 1, SEARCH_QUERIES).astype(int):
        got = comp.search_corpus(fps[qi], packed, max_results=12)
        want = comp.search_corpus(fps[qi], on_cpu, max_results=24)
        res["search_tied_runs"] += _same_ranking(
            f"search_corpus, query {qi}", [mm.fingerprint.id for mm in got],
            [mm.similarity.overall_similarity for mm in got], [mm.fingerprint.id for mm in want],
            [mm.similarity.overall_similarity for mm in want])
    log(f"[search_corpus] {SEARCH_QUERIES} queries from the batch: card and CPU rank the same ids "
        f"({res['search_tied_runs']} runs of similarities within {parity.COMPARATOR_HOST_ATOL} "
        f"compared as sets)")
    del packed, built, on_cpu, m
    torch.cuda.empty_cache()

    # phase 29: a corpus of 262,144 packed rows (bench.py:585-595), 64 of
    # them copies of row `src`, so a search for that row ties
    torch.cuda.reset_peak_memory_stats()
    D = DC.layout_size(13)
    corpus, src, dups, rng = corpus_rows(D)
    X = torch.from_numpy(corpus).to(dev)
    X_cpu = torch.from_numpy(corpus)
    w = np.array([0.35, 0.25, 0.10, 0.20, 0.10, 0.10], np.float32)
    match = torch.ones(CORPUS_ROWS, dtype=torch.bool)
    qv = rng.standard_normal(D).astype(np.float32)
    kw = dict(num_mfcc_coeffs=13)
    n = 4096
    got = DC.batched_similarity(qv, X[:n], w, match[:n].to(dev), **kw)
    want = DC.batched_similarity(qv, X_cpu[:n], w, match[:n], **kw)
    res["similarity_err"] = max(float((got[k].cpu() - want[k]).abs().max())
                                for k in ("overall", "confidence", "feature_sims"))
    same = all(torch.equal(got[k].cpu(), want[k]) for k in ("match_class", "feature_present"))
    log(f"[batched_similarity at C = {n}, card vs CPU] max |diff| {res['similarity_err']:.3g} "
        f"(limit {parity.COMPARATOR_HOST_ATOL}); classes and gates equal: {same}")
    if not (res["similarity_err"] <= parity.COMPARATOR_HOST_ATOL and same):
        raise AssertionError("batched_similarity on the card disagrees with the CPU")
    match_dev = match.to(dev)
    # a random query: the recipe's 2-vector cosines crowd its top scores
    # within ~1e-7 of each other, so runs within the bound compare as sets
    got = DC.topk_similarity(qv, X, w, match_dev, k=TOP_K, **kw)
    want = DC.topk_similarity(qv, X_cpu, w, match, k=2 * TOP_K, **kw)
    res["topk_tied_runs"] = _same_ranking(
        "topk_similarity, random query", got["index"].tolist(), got["overall"].tolist(),
        want["index"].tolist(), want["overall"].tolist())
    log(f"[topk_similarity k = {TOP_K}, random query] card {got['index'].tolist()}, the CPU's ranking "
        f"({res['topk_tied_runs']} runs of scores within {parity.COMPARATOR_HOST_ATOL} compared as sets)")
    # the duplicated row: 65 exactly equal scores, lowest index first on both
    got = DC.topk_similarity(corpus[src], X, w, match_dev, k=TOP_K, **kw)
    want = DC.topk_similarity(corpus[src], X_cpu, w, match, k=TOP_K, **kw)
    tied = sorted([src, *dups.tolist()])[:TOP_K]
    log(f"[topk_similarity k = {TOP_K}, a row with {CORPUS_DUPLICATES} copies] card "
        f"{got['index'].tolist()}, CPU {want['index'].tolist()}")
    if not (got["index"].tolist() == want["index"].tolist() == tied
            and len(set(got["overall"].tolist())) == 1):
        raise AssertionError(f"the tied rows are not lowest index first: expected {tied}")
    res["topk_ties_lowest_first"] = True

    res["similarity_ms"] = cuda_ms(lambda: DC.batched_similarity(qv, X, w, match_dev, **kw), 10)
    res["topk_ms"] = cuda_ms(lambda: DC.topk_similarity(qv, X, w, match_dev, k=TOP_K, **kw), 10)
    # the public search: placeholder fingerprints for the random rows, real
    # queries from the batch (packed on the host per search)
    news = DC.content_code(ContentType.NEWS)
    shells = [AudioFingerprint(f"r{i}", "", ContentType.NEWS, 0.0, 30.0, SR, HOP, 1, None)
              for i in range(CORPUS_ROWS)]
    big = DC.PackedCorpus(shells, X, torch.full((CORPUS_ROWS,), news, dtype=torch.int32, device=dev), 13)
    queries = [fps[i] for i in range(0, FULL_B, FULL_B // 8)]
    comp.search_corpus(queries[0], big, max_results=12)
    one = []
    for q in queries:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comp.search_corpus(q, big, max_results=12)
        one.append(time.perf_counter() - t0)
    res["search_blocking_ms"] = 1e3 * float(np.median(one))
    stream = [queries[i % len(queries)] for i in range(32)]
    list(comp.search_corpus_stream(stream[:8], big, max_results=12, depth=4))  # pinned buffers
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streamed = list(comp.search_corpus_stream(stream, big, max_results=12, depth=4))
    res["search_pipelined_ms"] = 1e3 * (time.perf_counter() - t0) / len(stream)
    packs = []
    for q in queries:
        t0 = time.perf_counter()
        DC.pack_comparator_stats(q, 13)
        packs.append(time.perf_counter() - t0)
    res["query_pack_ms"] = 1e3 * float(np.median(packs))
    for q, got in zip(stream[:len(queries)], streamed):
        want = comp.search_corpus(q, big, max_results=12)
        if [mm.fingerprint.id for mm in got] != [mm.fingerprint.id for mm in want]:
            raise AssertionError("search_corpus_stream and search_corpus rank other ids")
    res["comparisons_per_s_pipelined"] = CORPUS_ROWS / (1e-3 * res["search_pipelined_ms"])
    log(f"corpus search at C = {CORPUS_ROWS}: batched_similarity {res['similarity_ms']:.3f} ms "
        f"({CORPUS_ROWS / (1e-3 * res['similarity_ms']) / 1e6:.0f} M comparisons/s), "
        f"topk_similarity {res['topk_ms']:.3f} ms (CUDA events); search_corpus blocking "
        f"{res['search_blocking_ms']:.3f} ms (median of {len(one)}), pipelined at depth 4 "
        f"{res['search_pipelined_ms']:.3f} ms per query = "
        f"{res['comparisons_per_s_pipelined'] / 1e6:.0f} M comparisons/s; the query's host pack "
        f"{res['query_pack_ms']:.3f} ms of each [{card}]")
    profile_step("search_corpus_stream, 32 queries",
                 lambda: list(comp.search_corpus_stream(stream, big, max_results=12, depth=4)))
    del shells, big, streamed

    qmat = rng.standard_normal((MULTI_QUERIES, D)).astype(np.float32)
    wmat = np.tile(w, (MULTI_QUERIES, 1))
    q_codes = np.zeros(MULTI_QUERIES, np.int32)
    c_codes = torch.zeros(CORPUS_ROWS, dtype=torch.int32, device=dev)
    multi = DC.topk_similarity_multi(qmat, X, wmat, q_codes, c_codes, k=TOP_K, **kw)
    res["multi_tied_runs"] = 0
    for i in range(MULTI_QUERIES):
        single = DC.topk_similarity(qmat[i], X, w, match_dev, k=2 * TOP_K, **kw)
        res["multi_tied_runs"] += _same_ranking(
            f"topk_similarity_multi row {i}", multi["index"][i].tolist(), multi["overall"][i].tolist(),
            single["index"].tolist(), single["overall"].tolist())
    res["multi_ms"] = cuda_ms(lambda: DC.topk_similarity_multi(qmat, X, wmat, q_codes, c_codes,
                                                               k=TOP_K, **kw), 5)
    log(f"[topk_similarity_multi Q = {MULTI_QUERIES}, k = {TOP_K}] rows equal topk_similarity's "
        f"({res['multi_tied_runs']} runs of scores within {parity.COMPARATOR_HOST_ATOL} compared as "
        f"sets); {res['multi_ms']:.3f} ms = "
        f"{MULTI_QUERIES * CORPUS_ROWS / (1e-3 * res['multi_ms']) / 1e6:.0f} M comparisons/s [{card}]")
    del multi

    # the quality chain at C = 4,096 with 5,164-frame series, card vs CPU
    t = (FULL_SECONDS * SR - WINDOW) // HOP + 1
    series = rng.uniform(200, 8000, (n + 1, 2, t)).astype(np.float32)
    lens = rng.integers(t // 2, t + 1, (n + 1, 2)).astype(np.int32)
    lens[1] = 1                                      # a one-frame series: skipped
    series[2, 1] = 818.2999877929688                 # a constant series: skipped
    avail = (rng.random((n + 1, 6)) < 0.9).astype(np.float32)
    dur = rng.uniform(5, 60, n + 1).astype(np.float32)
    outs = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        def on(a, d=d):
            return torch.from_numpy(np.ascontiguousarray(a)).to(d)

        out = DC.batched_similarity_detailed(
            corpus[src], on(corpus[:n]), w, on(np.ones(n, bool)), avail[0], on(avail[1:]),
            np.float32(dur[0]), on(dur[1:]), series[0], on(series[1:]), lens[0], on(lens[1:]), **kw)
        outs[where] = {k: v.cpu() for k, v in out.items()}
    errs = {k: float((outs["card"][k].float() - outs["cpu"][k].float()).abs().max()) for k in outs["cpu"]}
    res["detailed_err"] = errs
    log(f"[batched_similarity_detailed C = {n}, T = {t}, card vs CPU] " + json.dumps(errs))
    for k, e in errs.items():
        limit = (parity.COMPARATOR_COHERENCE_ATOL if k == "spectral_coherence" else
                 parity.COMPARATOR_QUALITY_ATOL if k in ("temporal_alignment", "noise_level",
                                                          "dynamic_range_match", "confidence")
                 else parity.COMPARATOR_HOST_ATOL)
        if not e <= limit:
            raise AssertionError(f"batched_similarity_detailed {k}: card vs CPU {e:.3g} > {limit}")
    res["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    log(f"phase 29 peak device memory {res['peak_mib']:.0f} MiB [{card}]")

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        DC.batched_similarity(qv, X[:n], w, match_dev[:n], **kw)
    except ValueError as e:
        log(f"[TF32 on] batched_similarity raised: {e}")
    else:
        raise AssertionError("batched_similarity ran on the card with TF32 on")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    del X, X_cpu, corpus
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_start
    log(f"phases 28-29 took {res['seconds']:.1f} s")
    return res


INGEST_FILES, INGEST_SECONDS = 64, 30      # phase 33: mono 16-bit WAVs at SR
STEREO_FILES, STEREO_SR = 4, 48000        # phase 33: stereo 16-bit WAVs, resampled on decode
WAV_ATOL = 1e-6                           # tests/test_native_io.py's native-vs-stdlib bound
LATENCY_SECONDS, LATENCY_BUDGET = 60, 30.0
LATENCY_LAG = int(1.234 * SR) + 137       # phase 34's injected CDN delay, off the hop grid
QUERY_FILE = 17                           # phase 34's corpus query: this file plus noise
STREAM_BATCHES, STREAM_CLIP_SECONDS = 8, 30  # phase 36: host batches of FULL_B clips
MONITOR_PAIRS, MONITOR_SECONDS = 64, 60.0    # phase 36: batch_monitor at fleet width
TRACE_ROUNDS = 3                              # phase 36: in-process traces, each gated


def kernel_wrappers() -> dict:
    """Each kernel's wrapper and the name of its launch counter."""
    from sonido_sonar_tpu_torch.ops import hopper_contrast, hopper_onsets, hopper_stft, hopper_yin
    from sonido_sonar_tpu_torch.ops.stats import hopper_backtrack, hopper_dtw

    k1, k2 = hopper_stft.stft_magnitude_hopper, hopper_yin.yin_pitch_hopper
    return {"K1": (k1, "launches"), "K10": (k1, "feat_launches"), "K2": (k2, "launches"),
            "K2amp": (k2, "amp_launches"), "K3": (hopper_yin.yin_difference_hopper, "launches"),
            "K4": (hopper_onsets.thin_onsets_hopper, "launches"),
            "K9": (hopper_contrast.band_select_means_hopper, "launches"),
            "fill": (hopper_dtw.fill_banded_hopper, "launches"),
            "backtrack": (hopper_backtrack.backtrack_banded_hopper, "launches")}


def zero_launches() -> None:
    for fn, attr in kernel_wrappers().values():
        setattr(fn, attr, 0)


def read_launches() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in kernel_wrappers().items()}


def counted(fn):
    """(fn's result, the kernels it launched, its host-clock seconds):
    counts set to 0 just before the call, read just after it."""
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, read_launches(), time.perf_counter() - t0


def ingest_clip(i: int, seconds: int) -> np.ndarray:
    """Phase 33's file i at SR: speech-like, music-like or a harmonic
    tone plus noise by i mod 3, each seeded from SEED and i."""
    from sonido_sonar_tpu_torch.io.synth import harmonic_tone, music_like, speech_like, white_noise

    seed = SEED + 100 + i
    if i % 3 == 0:
        return speech_like(seconds, SR, f0=100.0 + 5 * (i % 8), seed=seed,
                           random_syllables=True)
    if i % 3 == 1:
        return music_like(seconds, SR, tempo_bpm=90.0 + i, seed=seed)
    return harmonic_tone(110.0 + 7 * i, seconds, SR, num_harmonics=8, decay=0.85) \
        + white_noise(seconds, SR, 0.02, seed=seed)


def write_ingest_clip(i: int, seconds: int, path: str) -> str:
    from sonido_sonar_tpu_torch.io.decode import write_wav

    write_wav(path, ingest_clip(i, seconds), SR)
    return path


def stdlib_wav(path: str) -> tuple:
    """(mono float32 PCM, rate) read with the stdlib `wave` module alone,
    as tests/test_native_io.py reads its reference."""
    import wave

    with wave.open(path, "rb") as w:
        ch, sr = w.getnchannels(), w.getframerate()
        x = np.frombuffer(w.readframes(w.getnframes()), dtype="<i2").astype(np.float32) / 32768.0
    return (x.reshape(-1, ch).mean(axis=1) if ch > 1 else x), sr


def run_ingest(card: str, tmp: Path) -> dict:
    """Phase 33: 64 mono WAVs of 30 s at 44.1 kHz written with the port's
    write_wav (in a process pool: the speech generator is a Python loop)
    and 4 stereo 48 kHz WAVs written with the stdlib, all decoded by
    decode_files_parallel on the native path, each held to the stdlib
    read (the 48 kHz files resampled by _resample_polyphase), then the
    same files through the decoder's stdlib path. Returns the paths of the
    mono corpus and the {"ingest": ...} numbers."""
    import concurrent.futures
    import multiprocessing
    import wave

    from sonido_sonar_tpu_torch.io import native
    from sonido_sonar_tpu_torch.io.decode import _resample_polyphase, decode_files_parallel

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("phase 33: the native WAV loader is not available (g++ build)")
    build_s = time.perf_counter() - t0
    corpus = tmp / "corpus"
    corpus.mkdir()
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as ex:
        paths = list(ex.map(write_ingest_clip, range(INGEST_FILES),
                            [INGEST_SECONDS] * INGEST_FILES,
                            [str(corpus / f"clip{i:02d}.wav") for i in range(INGEST_FILES)]))
    stereo = []
    for j in range(STEREO_FILES):
        rng = np.random.default_rng(SEED + 300 + j)
        t = np.arange(STEREO_SR * INGEST_SECONDS) / STEREO_SR
        x = np.stack([0.4 * np.sin(2 * np.pi * (300.0 + 50 * j) * t),
                      0.2 * rng.standard_normal(len(t))], axis=1)
        p = str(tmp / f"stereo{j}.wav")
        with wave.open(p, "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(STEREO_SR)
            w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
        stereo.append(p)
    write_s = time.perf_counter() - t0
    files = paths + stereo
    audio_s = INGEST_SECONDS * len(files)

    t0 = time.perf_counter()
    audios = decode_files_parallel(files)
    native_s = time.perf_counter() - t0
    use_native = native.available
    native.available = lambda: False  # the decoder's stdlib path, for its time
    try:
        t0 = time.perf_counter()
        stdlib_audios = decode_files_parallel(files)
        stdlib_s = time.perf_counter() - t0
    finally:
        native.available = use_native
    worst = 0.0
    for p, a, s in zip(files, audios, stdlib_audios):
        ref, sr = stdlib_wav(p)
        if sr != SR:
            ref = _resample_polyphase(ref, sr, SR)
        for got in (a, s):
            if got is None or got.sample_rate != SR or got.pcm.shape != ref.shape:
                raise AssertionError(f"phase 33: {p} decoded to {None if got is None else got.pcm.shape}")
            worst = max(worst, float(np.abs(got.pcm - ref).max()))
    if not worst <= WAV_ATOL:
        raise AssertionError(f"phase 33: decoded PCM {worst:.3g} from the stdlib read (> {WAV_ATOL})")
    res = {"files": len(files), "audio_s": audio_s, "native_available": True,
           "native_build_s": build_s, "write_s": write_s, "max_abs_err": worst,
           "native": {"wall_s": native_s, "ms_per_file": 1e3 * native_s / len(files),
                      "audio_h_per_wall_h": audio_s / native_s},
           "stdlib": {"wall_s": stdlib_s, "ms_per_file": 1e3 * stdlib_s / len(files),
                      "audio_h_per_wall_h": audio_s / stdlib_s}}
    log(f"[ingest] {len(paths)} mono 44.1 kHz + {len(stereo)} stereo 48 kHz WAVs of "
        f"{INGEST_SECONDS} s written in {write_s:.1f} s; native loader ready in {build_s:.2f} s")
    log(f"[ingest] decode_files_parallel, native path: {native_s:.3f} s, "
        f"{res['native']['ms_per_file']:.2f} ms per file, "
        f"{res['native']['audio_h_per_wall_h']:.0f} audio-h per wall-h; stdlib path: "
        f"{stdlib_s:.3f} s, {res['stdlib']['ms_per_file']:.2f} ms per file, "
        f"{res['stdlib']['audio_h_per_wall_h']:.0f} audio-h per wall-h; every file within "
        f"{worst:.3g} of the stdlib read (limit {WAV_ATOL}) [{card}]")
    return paths, res


def run_cdn_latency(card: str, dev: torch.device, tmp: Path, corpus: list,
                    nvcc_s: float) -> dict:
    """Phase 34: examples/cdn_latency at full width on a speech-like and a
    music-like 60 s source and a CDN copy delayed by LATENCY_LAG (gain
    0.9, noise 0.02), both written as WAV: the refined latency within one
    hop, launches and the stage split, the first call against the warm
    one and a fresh process's run; then examples/corpus_search over phase
    33's files with a query of file QUERY_FILE plus noise. Returns the
    {"cdn_latency": ...} numbers."""
    from sonido_sonar_tpu_torch.examples import cdn_latency, corpus_search
    from sonido_sonar_tpu_torch.io.decode import write_wav
    from sonido_sonar_tpu_torch.io.synth import music_like, shift_signal, speech_like

    res = {"lag_samples": LATENCY_LAG, "budget_s": LATENCY_BUDGET, "nvcc_build_s": nvcc_s}
    sources = {"speech": speech_like(LATENCY_SECONDS, SR, seed=SEED + 200, random_syllables=True),
               "music": music_like(LATENCY_SECONDS, SR, seed=SEED + 201)}
    for label, src in sources.items():
        sp, cp = str(tmp / f"{label}_src.wav"), str(tmp / f"{label}_cdn.wav")
        write_wav(sp, src, SR)
        write_wav(cp, shift_signal(src, LATENCY_LAG, noise=0.02, gain=0.9), SR)
        calls = {}
        for call in ("first", "warm"):
            out, launches, wall_s = counted(lambda: cdn_latency.main(sp, cp, LATENCY_BUDGET,
                                                                     device=dev))
            err_ms = 1e3 * abs(out["latency_s"] - LATENCY_LAG / SR)
            calls[call] = {"wall_ms": 1e3 * wall_s, "stages_ms": out["ms"], "launches": launches,
                           "latency_ms": 1e3 * out["latency_s"], "err_ms": err_ms,
                           "coarse_ms": 1e3 * out["coarse_s"], "confidence": out["confidence"],
                           "method": out["method"], "content_type": out["content_type"]}
            log(f"[cdn_latency {label} {call}] {out['content_type']}, latency "
                f"{1e3 * out['latency_s']:.3f} ms (injected {1e3 * LATENCY_LAG / SR:.3f}, err "
                f"{err_ms:.3f} ms, one hop {1e3 * HOP / SR:.3f}), {out['method']}, confidence "
                f"{out['confidence']:.3f}; {1e3 * wall_s:.1f} ms: "
                + ", ".join(f"{k} {v:.1f}" for k, v in out["ms"].items())
                + f" ms; launches {launches} [{card}]")
            if not err_ms <= 1e3 * HOP / SR:
                raise AssertionError(f"cdn_latency {label}: {err_ms:.3f} ms from the injected lag")
            if launches["K1"] < 1:
                raise AssertionError(f"cdn_latency {label}: no K1 launch ({launches})")
        res[label] = calls
    # a fresh process, as a user's first command (the kernel and WAV
    # libraries already built in this checkout)
    sp, cp = str(tmp / "speech_src.wav"), str(tmp / "speech_cdn.wav")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "sonido_sonar_tpu_torch.examples.cdn_latency",
                           sp, cp, str(LATENCY_BUDGET)], capture_output=True, text=True,
                          timeout=600, cwd=Path(__file__).resolve().parent)
    fresh_s = time.perf_counter() - t0
    if proc.returncode != 0 or "latency" not in proc.stdout:
        raise AssertionError(f"cdn_latency in a fresh process failed: {proc.stderr[-3000:]}")
    res["fresh_process_s"] = fresh_s
    log(f"[cdn_latency cold start] the speech pair: first call in this process "
        f"{res['speech']['first']['wall_ms']:.1f} ms, warm {res['speech']['warm']['wall_ms']:.1f} "
        f"ms; a fresh `python -m ...examples.cdn_latency` {fresh_s:.2f} s; the kernels' nvcc "
        f"build {nvcc_s:.1f} s (once per checkout) [{card}]")

    rng = np.random.default_rng(SEED + 17)
    query = ingest_clip(QUERY_FILE, INGEST_SECONDS) + 0.02 * rng.standard_normal(INGEST_SECONDS * SR)
    qpath = str(tmp / "query.wav")
    write_wav(qpath, query.astype(np.float32), SR)
    matches, launches, wall_s = counted(
        lambda: corpus_search.main(qpath, str(Path(corpus[0]).parent), k=5, device=dev))
    top = Path(matches[0].fingerprint.stream_url).name
    res["corpus_search"] = {"files": len(corpus), "wall_s": wall_s, "launches": launches,
                            "top": top, "top_similarity": matches[0].similarity.overall_similarity,
                            "second_similarity": (matches[1].similarity.overall_similarity
                                                  if len(matches) > 1 else None)}
    log(f"[corpus_search] {len(corpus)} files x {INGEST_SECONDS} s, query file {QUERY_FILE} + "
        f"noise 0.02: rank 1 {top} ({res['corpus_search']['top_similarity']:.4f}, next "
        f"{res['corpus_search']['second_similarity']}); {wall_s:.2f} s; launches {launches} [{card}]")
    if top != Path(corpus[QUERY_FILE]).name:
        raise AssertionError(f"corpus_search ranked {top} first, not file {QUERY_FILE}")
    if launches["K1"] < len(corpus):
        raise AssertionError(f"corpus_search: {launches['K1']} K1 launches for {len(corpus)} files")
    return res


def eval_gate_misses(summary: dict, min_accept: float) -> list:
    """Gates 1, 2 and 4 of tests/test_eval_gates.py on a run_extended
    summary: every default-path category within one hop (coarse and
    refined, median refined error within a hop) at a mean confidence of
    at least `min_accept`; the time-stretch errors below 1e-3."""
    misses = []
    for cat, s in summary["categories"].items():
        if cat.endswith("_unverified"):
            continue
        if s["coarse_within_one_hop"] != 1.0 or s["refined_within_one_hop"] != 1.0:
            misses.append(f"{cat}: within one hop {s['coarse_within_one_hop']}, "
                          f"{s['refined_within_one_hop']}")
        if s["refined_err_ms_median"] > summary["hop_ms"]:
            misses.append(f"{cat}: median refined error {s['refined_err_ms_median']} ms")
        if s["mean_confidence"] < min_accept:
            misses.append(f"{cat}: mean confidence {s['mean_confidence']} < {min_accept}")
    ts = summary["time_stretch"]
    if not ts["max_abs_error"] < 1e-3:
        misses.append(f"time stretch max error {ts['max_abs_error']}")
    if ts["dtw_slope_max_abs_error"] is not None and not ts["dtw_slope_max_abs_error"] < 1e-3:
        misses.append(f"DTW-slope stretch max error {ts['dtw_slope_max_abs_error']}")
    return misses


def comb_gate(dev: torch.device, sr: int, quick: bool, min_accept: float) -> dict:
    """Gate 3 of tests/test_eval_gates.py, "with verification forced off,
    a comb-ambiguous wrong answer must arrive below every accept
    threshold", on each music_bandlimited_unverified case: the cases run
    again one by one (run_extended reports only the category's mean)."""
    from sonido_sonar_tpu_torch import eval_accuracy as EA

    ext = EA.sweep_extractor(sr, dev)
    hop_s = ext.config.hop_size / sr
    cases = []
    for cat, src, cdn, lag, verify in EA.extended_cases(sr, quick):
        if cat == "music_bandlimited_unverified":
            feats, _ = EA.align_case(ext, src, cdn, sr, verify)
            cases.append({"lag": lag, "offset": round(feats.temporal_offset * sr),
                          "confidence": feats.offset_confidence,
                          "wrong": abs(feats.temporal_offset - lag / sr) > hop_s + 1e-6})
    return {"cases": cases, "wrong_below_accept": all(
        c["confidence"] < min_accept for c in cases if c["wrong"])}


def run_accuracy(card: str, dev: torch.device) -> dict:
    """Phase 35: the accuracy sweep on the card: run_extended at 44.1 kHz,
    full, against every gate of tests/test_eval_gates.py; run at 44.1 kHz,
    full, batched (the [B]-pair aligner's coarse offsets equal to the
    per-pair ones); run_extended at 22.05 kHz, quick, on the card and on
    the CPU with equal per-category within-one-hop rates. Returns the
    {"accuracy": ...} numbers."""
    from sonido_sonar_tpu_torch import eval_accuracy as EA
    from sonido_sonar_tpu_torch.config.config import ContentType, alignment_config_for_content

    min_accept = min(alignment_config_for_content(ct).min_confidence for ct in ContentType)
    full, launches, full_s = counted(lambda: EA.run_extended(SR, quick=False, device=dev))
    for cat, s in full["categories"].items():
        log(f"[accuracy 44.1 kHz full] {cat}: {json.dumps(s)}")
    log(f"[accuracy 44.1 kHz full] time stretch {json.dumps(full['time_stretch'])}; "
        f"{full_s:.1f} s, launches {launches} [{card}]")
    misses = eval_gate_misses(full, min_accept)
    comb = comb_gate(dev, SR, False, min_accept)
    stats = full["categories"]["music_bandlimited_unverified"]
    comb["category_mean_form"] = (stats["coarse_within_one_hop"] == 1.0
                                  or stats["mean_confidence"] < min_accept)
    log(f"[accuracy 44.1 kHz full] gate 3 per case: {json.dumps(comb['cases'])}; every wrong "
        f"answer below {min_accept}: {comb['wrong_below_accept']}; the category-mean form of "
        f"tests/test_eval_gates.py (mean {stats['mean_confidence']:.4f} over right and wrong "
        f"answers): {comb['category_mean_form']}")
    if not comb["wrong_below_accept"]:
        misses.append("music_bandlimited_unverified: a wrong answer at or above the accept "
                      "threshold")
    if misses:
        raise AssertionError("the 44.1 kHz sweep misses the gates: " + "; ".join(misses))
    if launches["fill"] < 1 or launches["backtrack"] < 1:
        raise AssertionError(f"the sweep's chroma DTW did not run the DTW kernels: {launches}")
    lagged, lag_launches, lagged_s = counted(lambda: EA.run(SR, quick=False, batched=True,
                                                            device=dev))
    log(f"[accuracy 44.1 kHz run, batched] {json.dumps(lagged)}; {lagged_s:.1f} s, launches "
        f"{lag_launches} [{card}]")
    if not lagged["batched"]["coarse_identical_to_per_pair"]:
        raise AssertionError("the batched aligner's coarse offsets differ from the per-pair ones")
    t0 = time.perf_counter()
    card_quick = EA.run_extended(22050, quick=True, device=dev)
    card_quick_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_quick = EA.run_extended(22050, quick=True, device="cpu")
    cpu_quick_s = time.perf_counter() - t0
    rates = ("coarse_within_one_hop", "refined_within_one_hop")
    differ = [c for c in cpu_quick["categories"]
              if any(card_quick["categories"][c][r] != cpu_quick["categories"][c][r] for r in rates)]
    conf_diff = max(abs(card_quick["categories"][c]["mean_confidence"]
                        - cpu_quick["categories"][c]["mean_confidence"])
                    for c in cpu_quick["categories"])
    log(f"[accuracy 22.05 kHz quick] card {card_quick_s:.1f} s, CPU {cpu_quick_s:.1f} s; "
        f"within-one-hop rates equal in {len(cpu_quick['categories']) - len(differ)} of "
        f"{len(cpu_quick['categories'])} categories; mean confidences within {conf_diff:.3g} [{card}]")
    if differ or list(card_quick["categories"]) != list(cpu_quick["categories"]):
        raise AssertionError(f"the card's quick sweep differs from the CPU's in {differ}")
    return {"full_44100": full, "full_s": full_s, "full_launches": launches, "comb_gate": comb,
            "run_batched_44100": lagged, "run_batched_s": lagged_s,
            "quick_22050_card_s": card_quick_s, "quick_22050_cpu_s": cpu_quick_s,
            "quick_22050_confidence_max_diff": conf_diff, "min_accept": min_accept}


TRACE_STEP = """
import json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as C
from sonido_sonar_tpu_torch.models import FingerprintModel
from sonido_sonar_tpu_torch.utils import parity
torch.backends.cuda.matmul.allow_tf32 = False
x = parity.synth_pcm(C.FULL_B, C.STREAM_CLIP_SECONDS * C.SR, C.SEED + 36, C.SR, "cuda")
model = FingerprintModel(device="cuda")
model(x)
print(json.dumps(C.traced_step(model, x)))
"""


def traced_step(model, x: torch.Tensor, bare: bool = False) -> dict:
    """One main-path step under utils.profiler_trace (or, `bare`, a plain
    torch.profiler session with the same trace handler and no warm-up):
    the kernel records its Chrome trace holds, the host's kernel launches
    it holds (runtime or driver launch calls), the least time from a
    launch call to its kernel's start (negative when the device records'
    clock leads the host's), and the launches counted around the step."""
    from sonido_sonar_tpu_torch.utils import profiler_trace

    def bare_trace(d):
        torch.cuda.synchronize()
        return torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
            on_trace_ready=torch.profiler.tensorboard_trace_handler(d))

    with tempfile.TemporaryDirectory() as d:
        zero_launches()
        with (bare_trace if bare else profiler_trace)(d):
            model(x)
            torch.cuda.synchronize()
        launches = read_launches()
        traces = list(Path(d).glob("*.pt.trace.json"))
        events = json.loads(traces[0].read_text())["traceEvents"] if len(traces) == 1 else []
    kernels = [e for e in events if e.get("cat") == "kernel"]
    calls = {e["args"]["correlation"]: e["ts"] for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver") and "LaunchKernel" in e.get("name", "")
             and "correlation" in e.get("args", {})}
    lags = [k["ts"] - calls[k["args"]["correlation"]] for k in kernels
            if k.get("args", {}).get("correlation") in calls]
    return {"files": len(traces), "events": len(events), "kernels": len(kernels),
            "launch_calls": len(calls), "min_launch_to_kernel_us": min(lags, default=None),
            "names_k1": any("stft_aux_kernel" in k.get("name", "") for k in kernels),
            "launches": launches}


def run_stream_phase(card: str, dev: torch.device) -> dict:
    """Phase 36: one main-path step under profiler_trace in a fresh
    process and TRACE_ROUNDS times in this one, each trace holding a kernel record for each
    of its launch calls and naming K1's kernel (the same step under a
    bare torch.profiler session in turns, logged); FingerprintModel over
    STREAM_BATCHES host batches of FULL_B x 30 s, under
    run_stream(drain_every=2) and as blocking calls, in turns (outputs bit-equal, in order; audio-hours per
    wall-hour both ways; the busy share of one profiled window of the
    stream); examples/batch_monitor at its defaults and at MONITOR_PAIRS x
    MONITOR_SECONDS. Returns the {"stream": ...} numbers."""
    from sonido_sonar_tpu_torch.examples import batch_monitor
    from sonido_sonar_tpu_torch.models import FingerprintModel
    from sonido_sonar_tpu_torch.parallel.pipeline import run_stream
    from sonido_sonar_tpu_torch.utils import parity

    base = parity.synth_pcm(FULL_B, STREAM_CLIP_SECONDS * SR, SEED + 36, SR).numpy()
    batches = [np.roll(base, 4410 * k, axis=1) * np.float32(1.0 - 0.03 * k)
               for k in range(STREAM_BATCHES)]
    del base
    audio_h = STREAM_BATCHES * FULL_B * STREAM_CLIP_SECONDS / 3600.0
    model = FingerprintModel(device=dev)
    model(torch.from_numpy(batches[0]).to(dev))
    # the gates: one step traced in a fresh process, as a profiling run is
    # made, and the same step traced here, after the earlier phases, each
    # holding a kernel record for each launch call it recorded (K1's
    # named, as many calls in both); the same step under a bare session
    # is logged (such traces lost their first kernel records, K1's among
    # them, and kept every launch call)
    proc = subprocess.run([sys.executable, "-c", TRACE_STEP, str(Path(__file__).resolve().parent)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the traced step failed: {proc.stderr[-3000:]}")
    x0 = torch.from_numpy(batches[0]).to(dev)
    rounds = [(traced_step(model, x0, bare=True), traced_step(model, x0)) for _ in range(TRACE_ROUNDS)]
    res = {"trace": json.loads(proc.stdout.strip().splitlines()[-1]),
           "trace_in_this_process_bare": [b for b, _ in rounds],
           "trace_in_this_process": [t for _, t in rounds]}
    log(f"[profiler_trace] one main-path step in a fresh process: {res['trace']}; in this "
        f"process, in turns, under a bare torch.profiler session: {res['trace_in_this_process_bare']}; "
        f"under profiler_trace: {res['trace_in_this_process']} [{card}]")
    for where, got in [("a fresh process", res["trace"])] + [
            (f"this process, round {i}", t) for i, t in enumerate(res["trace_in_this_process"])]:
        if (not got["names_k1"] or got["kernels"] != got["launch_calls"]
                or got["launch_calls"] != res["trace"]["launch_calls"] or got["launches"]["K1"] != 1):
            raise AssertionError(f"profiler_trace ({where}): {got['kernels']} kernel records of "
                                 f"{got['launch_calls']} launch calls ({res['trace']['launch_calls']} "
                                 f"in a fresh process), K1 named: {got['names_k1']}")

    def blocking():
        outs = []
        for b in batches:
            outs.append(model(torch.from_numpy(b).to(dev)))
            torch.cuda.synchronize()
        return outs

    def streamed():
        return list(run_stream(model, batches, drain_every=2, device=dev))

    # the first pass allocates the pinned staging buffers (cudaHostAlloc,
    # then cached by torch's host allocator); a stream pays it once
    _, _, cold_s = counted(lambda: list(run_stream(model, batches[:3], drain_every=2,
                                                   device=dev)))
    want, block_launches, block_s1 = counted(blocking)           # in turns: blocking,
    got, stream_launches, stream_s1 = counted(streamed)          # streamed, streamed,
    if len(got) != len(want):                                    # blocking
        raise AssertionError(f"run_stream yielded {len(got)} results for {len(want)} batches")
    for k, (g, w) in enumerate(zip(got, want)):
        bad = [key for key in w if not torch.equal(g[key], w[key])]
        if bad or sorted(g) != sorted(w):
            raise AssertionError(f"run_stream step {k} differs from the blocking call in {bad}")
    del got, want
    if stream_launches["K1"] != STREAM_BATCHES or stream_launches["K2"] != STREAM_BATCHES:
        raise AssertionError(f"run_stream: launches {stream_launches}")
    stream_s2 = counted(streamed)[2]
    block_s2 = counted(blocking)[2]
    block_s, stream_s = (block_s1 + block_s2) / 2, (stream_s1 + stream_s2) / 2
    busy = profile_step("run_stream 4 batches",
                        lambda: list(run_stream(model, batches[:4], drain_every=2, device=dev)))
    res.update({"batches": STREAM_BATCHES, "batch": FULL_B, "clip_s": STREAM_CLIP_SECONDS,
                "first_pass_3_batches_s": cold_s, "blocking_s": [block_s1, block_s2],
                "stream_s": [stream_s1, stream_s2], "launches": stream_launches,
                "blocking_audio_h_per_wall_h": audio_h / (block_s / 3600.0),
                "stream_audio_h_per_wall_h": audio_h / (stream_s / 3600.0),
                "stream_busy_share": busy, "bit_equal": True})
    log(f"[run_stream] {STREAM_BATCHES} host batches of {FULL_B} x {STREAM_CLIP_SECONDS} s, in "
        f"turns: blocking {block_s1:.3f} and {block_s2:.3f} s "
        f"({res['blocking_audio_h_per_wall_h']:.0f} audio-h per wall-h), "
        f"run_stream(drain_every=2) {stream_s1:.3f} and {stream_s2:.3f} s "
        f"({res['stream_audio_h_per_wall_h']:.0f}); the first pass over 3 batches (pinned "
        f"buffers allocated) {cold_s:.3f} s; outputs bit-equal in order; launches "
        f"{stream_launches}; busy {100 * busy:.1f} % of a profiled 4-batch window [{card}]")

    for n_pairs, seconds in ((8, 12.0), (MONITOR_PAIRS, MONITOR_SECONDS)):
        out, launches, wall_s = counted(lambda: batch_monitor.main(n_pairs, seconds, device=dev))
        res[f"batch_monitor_{n_pairs}x{seconds:.0f}"] = {**out, "wall_s": wall_s,
                                                         "launches": launches}
        log(f"[batch_monitor {n_pairs} x {seconds:.0f} s] exact-sample recovery "
            f"{out['exact']}/{n_pairs}, step {out['ms']:.2f} ms, launches {launches} [{card}]")
    return res


def near_zero_for(x: torch.Tensor, music: bool) -> np.ndarray:
    """Frames exempt from the exact ZCR comparison (utils/parity): a
    sample near 0 after the path's preprocessing, from CPU PCM."""
    from sonido_sonar_tpu_torch.ops.filters import dc_removal, pre_emphasis_for_content
    from sonido_sonar_tpu_torch.utils import parity

    if music:
        pre = pre_emphasis_for_content(dc_removal(x), "music").numpy()
        return parity.near_zero_frames(pre, WINDOW, HOP, 0.0, parity.DC_NEAR_ZERO)
    return parity.near_zero_frames(x.numpy(), WINDOW, HOP, 0.97)


def chord_margin(chroma: np.ndarray) -> np.ndarray:
    """The gap between the two best chord templates of each frame (chord
    indices within 1e-5 of a tie are exempt, utils/parity)."""
    from sonido_sonar_tpu_torch.ops.tonal import CHORD_MATRIX

    cn = chroma / np.maximum(np.linalg.norm(chroma, axis=-1, keepdims=True), 1e-10)
    sims = np.sort(cn @ CHORD_MATRIX.T, axis=-1)
    return sims[..., -1] - sims[..., -2]


MUSIC_OPTION_STEPS = 3   # phase 37: timed steps of each music configuration, in turns
TONAL_CLIPS = 4          # phase 37: clips whose tonal surface is held to the CPU
TONAL_ITERS = 3          # phase 37: timed calls of each tonal op after its warm-up
PITCH_METHODS = ("yin", "acf", "nsdf", "cepstrum", "hps", "zcr", "peaks", "yin+acf")
MODULATIONS = (7, 5, 2, 9)  # phase 37: semitones each chord clip's second half is raised


def chord_clips(count: int, seconds: int) -> torch.Tensor:
    """[count, seconds * SR] clips whose chords and key change: the first
    half io.synth.music_like (C major's I-V-vi-IV, a chord each 2 s, a
    melody note and a beat), the second half the same recipe with another
    seed raised by MODULATIONS[i] semitones (resampled by linear
    interpolation), each clip at its own tempo."""
    from sonido_sonar_tpu_torch.io.synth import music_like

    half = seconds * SR // 2
    out = []
    for i in range(count):
        r = 2.0 ** (MODULATIONS[i % len(MODULATIONS)] / 12)
        tempo = 90.0 + 8 * i
        first = music_like(half / SR, SR, tempo, seed=SEED + 300 + i)
        src = music_like(half * r / SR + 0.01, SR, tempo, seed=SEED + 400 + i)
        second = np.interp(np.arange(half) * r, np.arange(len(src)), src)
        out.append(np.concatenate([first, second]))
    return torch.from_numpy(np.stack(out).astype(np.float32))


def _same_chords(what: str, got, ref) -> int:
    """ChordDetector.detect_sequence on the card and the CPU, frame by
    frame: the same chord, or one whose CPU score is within MUSIC_TIE of
    the CPU's best. Returns the count of such near-tied frames."""
    from sonido_sonar_tpu_torch.utils import parity

    ties = 0
    for t, (g, r) in enumerate(zip(got, ref, strict=True)):
        if g.chord == r.chord:
            continue
        score = {(c.root, c.quality): c.score for c in r.candidates}.get((g.root, g.quality))
        if score is None or r.candidates[0].score - score > parity.MUSIC_TIE:
            raise AssertionError(f"{what} frame {t}: {g.chord} on the card, {r.chord} on the CPU")
        ties += 1
    return ties


def _same_keys(what: str, got, ref) -> None:
    """KeyEstimator results on the card and the CPU: correlations within
    MUSIC_RTOL / MUSIC_ATOL, the key where the top two are not near-tied,
    the stability and the modulations' windows equal."""
    from sonido_sonar_tpu_torch.utils import parity

    require(parity_close(what, got.all_correlations, ref.all_correlations, parity.MUSIC_RTOL,
                         parity.MUSIC_ATOL), what)
    if ref.confidence > parity.MUSIC_TIE and (got.key, got.mode) != (ref.key, ref.mode):
        raise AssertionError(f"{what}: {got.key} {got.mode} on the card, {ref.key} {ref.mode} on the CPU")
    if got.stability != ref.stability or [m["window"] for m in got.modulations] != [
            m["window"] for m in ref.modulations]:
        raise AssertionError(f"{what}: stability or modulations differ")


def parity_close(name: str, got, ref, rtol: float, atol) -> tuple:
    """utils/parity's element check as a (errors, failures) report."""
    from sonido_sonar_tpu_torch.utils import parity

    errors, failures = {}, []
    parity._close(name, got, ref, rtol, atol, errors, failures)
    return errors, failures


def run_music_analysis(card: str, dev: torch.device) -> dict:
    """Phase 37: the music program with both options on (CQT and HPCP
    chromas) at B=128 x 30 s on phase 13's clips (launch counts, shapes,
    unit-sum CQT and unit-energy HPCP rows, steps in turns with the
    options-off program, CQT and HPCP ms apart by CUDA events, peak
    memory), the same call card against CPU at [2, 44100] and at 16 kHz,
    and the tonal surface on the card held to the CPU on TONAL_CLIPS
    clips: key sequences, chord sequences and progressions over the music
    program's chroma of chord_clips, PitchDetector.detect_track for every
    method and a hybrid (run at full width, rows held), the spectral HNR
    and SNR, the inharmonicity and the vibrato over the full-width
    magnitudes and tracks, and HarmonicTracking on one clip, each timed
    by warm_median_ms. Returns the {"music_analysis": ...} numbers."""
    from sonido_sonar_tpu_torch.ops import tonal, tracking
    from sonido_sonar_tpu_torch.ops.chroma import chroma_cqt, hpcp_from_magnitude
    from sonido_sonar_tpu_torch.ops.hopper_stft import stft_magnitude_hopper
    from sonido_sonar_tpu_torch.parallel.pipeline import batched_music_extractor_features
    from sonido_sonar_tpu_torch.utils import parity

    n_full = FULL_SECONDS * SR
    t_frames = (n_full - WINDOW) // HOP + 1
    t_cqt = (n_full - 8192) // 512 + 1
    clips = parity.harmonic_clips(FULL_B, n_full, SEED + 6, SR, 196.0, dev)

    def on():
        return batched_music_extractor_features(clips, SR, WINDOW, HOP, enable_cqt=True, enable_hpcp=True)

    def off():
        return batched_music_extractor_features(clips, SR, WINDOW, HOP)

    res: dict = {"batch": FULL_B, "clip_s": FULL_SECONDS}
    for label, fn in (("off", off), ("on", on)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out, launches, _ = counted(fn)
        res[f"peak_mib_{label}"] = torch.cuda.max_memory_allocated() / 2**20
        if launches["K1"] != 2 or launches["K4"] != 3 or launches["K9"] != 1 \
                or sum(launches.values()) != 6:
            raise AssertionError(f"phase 37: the music program ({label}) launched {launches}")
        res[f"launches_{label}"] = {k: v for k, v in launches.items() if v}
    schema = {**music_schema(FULL_B, n_full), "chroma_cqt": (FULL_B, t_cqt, 12),
              "hpcp": (FULL_B, t_frames, 12)}
    check_surface("music program with CQT and HPCP", out, schema, MUSIC_INTS)
    cqt_sum = out["chroma_cqt"].sum(-1)
    hpcp_norm = torch.linalg.vector_norm(out["hpcp"], dim=-1)
    res["cqt_row_sum_err"] = float((cqt_sum[cqt_sum > 0] - 1).abs().max())
    res["hpcp_row_norm_err"] = float((hpcp_norm[hpcp_norm > 0] - 1).abs().max())
    res["hpcp_zero_rows"] = int((hpcp_norm == 0).sum())
    if res["cqt_row_sum_err"] > 1e-5 or res["hpcp_row_norm_err"] > 1e-5 or not bool((cqt_sum > 0).all()):
        raise AssertionError(f"phase 37: CQT rows not unit-sum or HPCP rows not unit-energy: {res}")
    del out
    log(f"[music program with CQT and HPCP B={FULL_B} x {FULL_SECONDS} s] launches "
        f"{res['launches_on']}; chroma_cqt [{FULL_B}, {t_cqt}, 12] rows sum to 1 within "
        f"{res['cqt_row_sum_err']:.2g}, hpcp [{FULL_B}, {t_frames}, 12] unit energy within "
        f"{res['hpcp_row_norm_err']:.2g} ({res['hpcp_zero_rows']} all-zero rows); peak device memory "
        f"{res['peak_mib_on']:.0f} MiB (options off {res['peak_mib_off']:.0f}) [{card}]")

    steps = {"off": [], "on": []}
    for label in ("off", "on", "on", "off"):                      # in turns
        steps[label] += timed_steps(on if label == "on" else off, MUSIC_OPTION_STEPS)
    audio_s = FULL_B * FULL_SECONDS
    for label in ("off", "on"):
        res[f"step_ms_{label}"] = report_steps(f"music program, options {label}, B={FULL_B} x "
                                               f"{FULL_SECONDS} s (in turns)", steps[label], audio_s, card)
        res[f"audio_h_per_wall_h_{label}"] = audio_s / (res[f"step_ms_{label}"] / 1e3)

    mag = stft_magnitude_hopper(clips, WINDOW, HOP)[0]
    for name, fn in (("cqt", lambda: chroma_cqt(clips, SR)),
                     ("hpcp", lambda: hpcp_from_magnitude(mag, SR, WINDOW))):
        fn()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res[f"{name}_ms"] = cuda_ms(fn, 3)
        res[f"{name}_peak_mib_above_inputs"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    log(f"[music options apart, CUDA events] chroma_cqt {res['cqt_ms']:.2f} ms (peak "
        f"{res['cqt_peak_mib_above_inputs']:.0f} MiB above its input), hpcp_from_magnitude "
        f"{res['hpcp_ms']:.2f} ms ({res['hpcp_peak_mib_above_inputs']:.0f} MiB) at B={FULL_B} x "
        f"{FULL_SECONDS} s; step with options {res['step_ms_on']:.2f} ms against "
        f"{res['step_ms_off']:.2f} without [{card}]")

    # card against CPU, the same call at [2, 44100] and at 16 kHz
    for sr, seed, f0 in ((SR, SEED + 8, 196.0), (16000, SEED + 8, 196.0)):
        small = parity.harmonic_clips(2, sr, seed, sr, f0)
        kw = dict(enable_cqt=True, enable_hpcp=True)
        card_out = {k: np32(v) for k, v in batched_music_extractor_features(small.to(dev), sr, **kw).items()}
        cpu_out = {k: v.numpy() for k, v in batched_music_extractor_features(small, sr, **kw).items()}
        errors = require(parity.check_extracted(
            card_out, cpu_out, sr, WINDOW, near_zero=near_zero_for(small, True), n_samples=sr,
            chord_margin=chord_margin(cpu_out["chroma"])),
            f"music program with CQT and HPCP [2, {sr}], card vs CPU")
        res[f"card_vs_cpu_{sr}"] = {k: v for k, v in errors.items() if "hpcp" in k or "cqt" in k}

    # the tonal surface: keys and chords over the program's chroma of
    # TONAL_CLIPS clips whose chords and key change
    chroma = batched_music_extractor_features(chord_clips(TONAL_CLIPS, FULL_SECONDS).to(dev), SR,
                                              WINDOW, HOP)["chroma"]

    def keys_chords():
        return ([tonal.KeyEstimator(device=dev).estimate_key_sequence(c) for c in chroma],
                [tonal.ChordProgressionAnalyzer(device=dev).analyze(c) for c in chroma])

    (keys_card, prog_card), res["keys_chords_card_ms"] = warm_median_ms(keys_chords, TONAL_ITERS)
    res["chord_ties"] = []
    for i, c in enumerate(chroma.cpu()):
        _same_keys(f"KeyEstimator.estimate_key_sequence clip {i}, card vs CPU", keys_card[i],
                   tonal.KeyEstimator(device="cpu").estimate_key_sequence(c))
        ties = _same_chords(f"ChordDetector.detect_sequence clip {i}, card vs CPU",
                            tonal.ChordDetector(device=dev).detect_sequence(chroma[i]),
                            tonal.ChordDetector(device="cpu").detect_sequence(c))
        if not ties and prog_card[i] != tonal.ChordProgressionAnalyzer(device="cpu").analyze(c):
            raise AssertionError(f"ChordProgressionAnalyzer clip {i}: card and CPU differ")
        res["chord_ties"].append(ties)
    res["keys"] = [f"{k.key} {k.mode}" for k in keys_card]
    res["modulations"] = [len(k.modulations) for k in keys_card]
    res["chord_changes"] = [p["num_changes"] for p in prog_card]
    if len(set(res["keys"])) < 2 or not sum(res["modulations"]) or not all(res["chord_changes"]):
        raise AssertionError(f"phase 37: the chord clips' keys or chords do not change: {res['keys']}, "
                             f"modulations {res['modulations']}, chord changes {res['chord_changes']}")
    log(f"[tonal: keys and chords over {TONAL_CLIPS} x {t_frames} chroma frames of chord clips] keys "
        f"{res['keys']}, modulations {res['modulations']}, chord changes {res['chord_changes']}, equal "
        f"to the CPU's (near-tied frames {res['chord_ties']}); {res['keys_chords_card_ms']:.1f} ms on "
        f"the card (median of {TONAL_ITERS} after a warm-up) [{card}]")

    # the pitch facade: full width on the card, TONAL_CLIPS rows held to the CPU
    res["pitch_ms"] = {}
    tracks = {}
    for method in PITCH_METHODS:
        det = tonal.PitchDetector(SR, method, device=dev)
        got, res["pitch_ms"][method] = warm_median_ms(
            lambda: det.detect_track(clips, PITCH_WINDOW, PITCH_HOP), TONAL_ITERS)
        p = np32(got.pitch)
        if p.shape != (FULL_B, (n_full - PITCH_WINDOW) // PITCH_HOP + 1) or not np.isfinite(p).all():
            raise AssertionError(f"PitchDetector {method}: pitch {p.shape}")
        ref = tonal.PitchDetector(SR, method, device="cpu").detect_track(
            clips[:TONAL_CLIPS].cpu(), PITCH_WINDOW, PITCH_HOP)
        args = (p[:TONAL_CLIPS], np32(got.confidence)[:TONAL_CLIPS], ref.pitch.numpy(), ref.confidence.numpy())
        check = parity.check_pitch if method == "yin" else parity.check_pitch_decisions
        require(check(*args), f"PitchDetector({method!r}).detect_track rows 0-{TONAL_CLIPS - 1}, card vs CPU")
        tracks[method] = got.pitch
    log(f"[PitchDetector.detect_track B={FULL_B} x {FULL_SECONDS} s, 1024/512] ms by method (median of "
        f"{TONAL_ITERS} after a warm-up) { {k: round(v, 2) for k, v in res['pitch_ms'].items()} } [{card}]")

    # HNR, SNR and inharmonicity over the full-width magnitudes
    an = tonal.HarmonicRatioAnalyzer(SR, device=dev)
    an_cpu = tonal.HarmonicRatioAnalyzer(SR, device="cpu")
    mag_cpu = mag[:TONAL_CLIPS].cpu()
    for name, fn, fn_cpu in (
        ("analyze_spectrum", lambda: an.analyze_spectrum(mag, WINDOW), lambda: an_cpu.analyze_spectrum(mag_cpu, WINDOW)),
        ("spectral_snr", lambda: an.spectral_snr(mag, WINDOW), lambda: an_cpu.spectral_snr(mag_cpu, WINDOW)),
    ):
        torch.cuda.reset_peak_memory_stats()
        got, res[f"{name}_ms"] = warm_median_ms(fn, TONAL_ITERS)
        res[f"{name}_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        require(parity_close(name, np32(got)[:TONAL_CLIPS], fn_cpu().numpy(), *parity.MUSIC_DB_TOL),
                f"HarmonicRatioAnalyzer.{name} [{FULL_B}, {t_frames}, 513] rows 0-{TONAL_CLIPS - 1}, card vs CPU")
    f0 = torch.full(mag.shape[:-1], 196.0, device=dev)
    inh, res["inharmonicity_ms"] = warm_median_ms(
        lambda: tonal.analyze_inharmonicity(mag, f0, SR, WINDOW), TONAL_ITERS)
    inh_cpu = tonal.analyze_inharmonicity(mag_cpu, f0[:TONAL_CLIPS].cpu(), SR, WINDOW)
    if not np.array_equal(np32(inh.num_partials)[:TONAL_CLIPS], inh_cpu.num_partials.numpy()):
        raise AssertionError("analyze_inharmonicity: partial counts differ, card vs CPU")
    require(parity_close("inharmonicity", np32(inh.inharmonicity)[:TONAL_CLIPS], inh_cpu.inharmonicity.numpy(),
                         parity.MUSIC_RTOL, parity.MUSIC_ATOL), "analyze_inharmonicity, card vs CPU")

    # vibrato: the YIN track, and tracks with 4-8 Hz vibrato at the same frame rate
    frame_rate = SR / PITCH_HOP
    t = torch.arange(tracks["yin"].shape[-1], device=dev) / frame_rate
    rate = torch.linspace(4.0, 8.0, FULL_B, device=dev)[:, None]
    synth = 200.0 + 8.0 * torch.sin(2 * np.pi * rate * t)
    for label, track in (("yin track", tracks["yin"]), ("4-8 Hz vibrato", synth)):
        got, ms = warm_median_ms(lambda: tonal.analyze_vibrato(track, PITCH_HOP, SR), TONAL_ITERS)
        ref = tonal.analyze_vibrato(track[:TONAL_CLIPS].cpu(), PITCH_HOP, SR)
        if not np.array_equal(np32(got["has_vibrato"])[:TONAL_CLIPS], ref["has_vibrato"].numpy()):
            raise AssertionError(f"analyze_vibrato ({label}): has_vibrato differs, card vs CPU")
        for k in ("vibrato_rate_hz", "vibrato_extent_hz"):
            require(parity_close(k, np32(got[k])[:TONAL_CLIPS], ref[k].numpy(), *parity.VIBRATO_TOL),
                    f"analyze_vibrato ({label}) {k}, card vs CPU")
        res[f"vibrato_{label.split()[0]}_ms"] = ms
    if not bool(got["has_vibrato"].all()):
        raise AssertionError("analyze_vibrato: a 4-8 Hz vibrato track reads as none")

    # partial tracking on one clip's spectrogram
    trk = tracking.HarmonicTracking(SR, device=dev)
    got, res["tracking_ms"] = warm_median_ms(lambda: trk.process_magnitude_spectrogram(mag[0], WINDOW),
                                             TONAL_ITERS)
    ref = tracking.HarmonicTracking(SR, device="cpu").process_magnitude_spectrogram(mag_cpu[0], WINDOW)
    if [vars(x) for x in got.tracks] != [vars(x) for x in ref.tracks]:
        raise AssertionError("HarmonicTracking: the tracks differ, card vs CPU")
    res["tracks"] = got.num_tracks
    log(f"[tonal on the full-width magnitudes] analyze_spectrum {res['analyze_spectrum_ms']:.1f} ms "
        f"(peak {res['analyze_spectrum_peak_mib']:.0f} MiB), spectral_snr {res['spectral_snr_ms']:.1f} ms, "
        f"analyze_inharmonicity {res['inharmonicity_ms']:.1f} ms, analyze_vibrato "
        f"{res['vibrato_yin_ms']:.1f} ms; HarmonicTracking on one {t_frames}-frame clip "
        f"{got.num_tracks} tracks in {res['tracking_ms']:.1f} ms (each the median of {TONAL_ITERS} "
        f"after a warm-up); all held to the CPU [{card}]")
    return res


SURFACE_ITERS = 3         # phase 38: timed calls of each op after its warm-up
SURFACE_CPU_ROWS = 2      # phase 38: clips each op is held to the CPU on
SURFACE_SHIFT = 5         # phase 38: semitones the chord clip's chroma is transposed
KNN_K = 16
CUSTOM_BANDS = (200.0, 500.0, 1000.0, 2000.0, 4000.0, 8000.0, 16000.0)


def corpus_rows(d: int) -> tuple:
    """Phase 29's corpus: CORPUS_ROWS rows of width d from numpy seeded
    with SEED + 29, CORPUS_DUPLICATES of them copies of row `src`.
    Returns (rows, src, the copies' indices, the generator)."""
    rng = np.random.default_rng(SEED + 29)
    corpus = rng.standard_normal((CORPUS_ROWS, d)).astype(np.float32)
    corpus[:, :6] = 1.0  # presence flags
    corpus[:, 29] = np.abs(corpus[:, 29])
    src = 5000
    dups = np.sort(rng.choice(np.delete(np.arange(CORPUS_ROWS), src), CORPUS_DUPLICATES, replace=False))
    corpus[dups] = corpus[src]
    return corpus, src, dups, rng


def kmeans_vs_cpu(x: torch.Tensor, k: int, dev: torch.device) -> dict:
    """Phase 38's k-means hold, card against CPU on the same frames and
    the same kmeans++ seeds: the assignment to the seeds equal but where
    a frame's two nearest seeds are within KMEANS_TIE_SCALE of its
    distance identity's scale; after the fit's 50 steps, where a boundary
    frame that flips moves its centroids, at most KMEANS_LABEL_MISS_SHARE
    of the labels differ and the inertia within KMEANS_INERTIA_RTOL."""
    from sonido_sonar_tpu_torch.ops.stats import clustering
    from sonido_sonar_tpu_torch.ops.stats.dtw import pairwise_sq_euclidean
    from sonido_sonar_tpu_torch.utils import parity

    x_cpu = x.cpu()
    init = torch.from_numpy(clustering._kmeanspp_init(x_cpu.numpy(), k, np.random.default_rng(SEED)))
    first = clustering._lloyd(x, init.to(dev), 0)[0].cpu()
    d2 = pairwise_sq_euclidean(x_cpu, init)
    two = torch.topk(d2, 2, dim=-1, largest=False).values
    scale = torch.sum(x_cpu * x_cpu, -1) + torch.amax(torch.sum(init * init, -1))
    tied = (two[:, 1] - two[:, 0]) <= parity.KMEANS_TIE_SCALE * scale
    ref_first = torch.argmin(d2, dim=-1)
    out = {"first_step_differ": int((first != ref_first).sum()), "first_step_near_ties": int(tied.sum())}
    if bool(((first != ref_first) & ~tied).any()):
        raise AssertionError(f"k-means: the assignment to the seeds differs away from ties, card vs CPU: {out}")
    fit_card = clustering.Clustering(num_clusters=k, seed=SEED, device=dev).fit(x)
    fit_cpu = clustering.Clustering(num_clusters=k, seed=SEED, device="cpu").fit(x_cpu)
    out["label_miss_share"] = float(np.mean(fit_card.labels != fit_cpu.labels))
    out["inertia_rel"] = abs(fit_card.inertia - fit_cpu.inertia) / fit_cpu.inertia
    out["centroid_max_abs"] = float(np.abs(fit_card.centroids - fit_cpu.centroids).max())
    log(f"[k-means K={k} on {x.shape[0]} frames, card vs CPU] {out}")
    if out["label_miss_share"] > parity.KMEANS_LABEL_MISS_SHARE or out["inertia_rel"] > parity.KMEANS_INERTIA_RTOL:
        raise AssertionError(f"k-means: card and CPU fits differ: {out}")
    return out


def run_op_surface(card: str, dev: torch.device) -> dict:
    """Phase 38: the op surface (ops/common, fft, chroma_analysis,
    stats/{distance,clustering,entropy,moments,percentiles} and the names
    of filters, temporal, spectral, speech, mel and mfcc) at B=128 x 30 s
    on the card: each op timed by warm_median_ms and held to the same op
    on the CPU over SURFACE_CPU_ROWS clips (utils/parity OPS_*,
    MOMENTS_RTOL, BLOCK_SCAN_*, SW_ATOL_SCALE), the launch counts of the
    ops' run (K1 and K4 launched, no other kernel), the peak device
    memory, and all six chroma sequence similarities on a chord clip and
    its transposition (OTI must find the shift). Returns the
    {"op_surface": ...} numbers."""
    from sonido_sonar_tpu_torch.fingerprint import device_compare as DC
    from sonido_sonar_tpu_torch.ops import chroma_analysis as CA
    from sonido_sonar_tpu_torch.ops import common, filters, mel, mfcc, spectral, speech, temporal
    from sonido_sonar_tpu_torch.ops.framing import frame_signal
    from sonido_sonar_tpu_torch.ops.hopper_stft import stft_magnitude_hopper
    from sonido_sonar_tpu_torch.ops.stats import clustering, distance, entropy, moments, percentiles
    from sonido_sonar_tpu_torch.ops.stft import stft
    from sonido_sonar_tpu_torch.parallel.pipeline import batched_fingerprint_features
    from sonido_sonar_tpu_torch.utils import parity

    t0 = time.perf_counter()
    rows = SURFACE_CPU_ROWS
    n_full = FULL_SECONDS * SR
    pcm = parity.synth_pcm(FULL_B, n_full, SEED + 38, SR, dev)
    pcm_cpu = pcm[:rows].cpu()
    feats = batched_fingerprint_features(pcm, SR, WINDOW, HOP)
    mfcc_b, chroma_b = feats["mfcc"], feats["chroma"]
    del feats
    mag = stft_magnitude_hopper(pcm, WINDOW, HOP)[0]
    # the chord clip whose chroma phase 38's sequence similarities compare
    q = batched_fingerprint_features(chord_clips(1, FULL_SECONDS).to(dev), SR, WINDOW, HOP)["chroma"][0]
    res: dict = {"batch": FULL_B, "clip_s": FULL_SECONDS, "ms": {}, "max_abs_err": {}}

    def hold(name, fn, cpu_fn, rtol=parity.OPS_RTOL, atol=parity.OPS_ATOL, rows_of=lambda o: o[:rows]):
        """Time fn() on the card; hold its leading rows to cpu_fn() (tensors,
        tuples or dicts of them) within rtol/atol."""
        out, res["ms"][name] = warm_median_ms(fn, SURFACE_ITERS)
        ref = cpu_fn()
        got = out
        if isinstance(ref, dict):
            pairs = [(f"{name}.{k}", rows_of(got[k]), ref[k]) for k in ref]
        elif isinstance(ref, tuple):
            pairs = [(f"{name}[{i}]", rows_of(g), r) for i, (g, r) in enumerate(zip(got, ref, strict=True))]
        else:
            pairs = [(name, rows_of(got), ref)]
        worst = 0.0
        for label, g, r in pairs:
            errors = require(parity_close(label, np32(g), r.numpy() if isinstance(r, torch.Tensor) else r,
                                          rtol, atol), f"{label}, card vs CPU")
            worst = max(worst, errors[label])
        res["max_abs_err"][name] = worst
        return out

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()

    # -- PCM [128, 1,323,000]: normalizers, resampling, filters, envelopes, tempo
    for method in ("zscore", "minmax", "energy", "peak", "rms", "quantile", "robust", "adaptive"):
        hold(f"normalize_{method}", lambda: common.normalize(pcm, method),
             lambda: common.normalize(pcm_cpu, method), atol=1e-5)
    hold("normalize_lufs", lambda: common.normalize_lufs(pcm, -23.0, SR),
         lambda: common.normalize_lufs(pcm_cpu, -23.0, SR), atol=1e-5)
    for method in ("linear", "cubic", "hermite", "lanczos"):
        hold(f"resample_{method}", lambda: common.resample_signal(pcm, SR, 16000, method),
             lambda: common.resample_signal(pcm_cpu, SR, 16000, method), atol=1e-5)
    scan_atol = f"scale:{parity.BLOCK_SCAN_F64_ATOL_SCALE}"
    hold("bandpass_q5", lambda: filters.bandpass(pcm, 1000.0, 5.0, SR),
         lambda: filters.bandpass(pcm_cpu, 1000.0, 5.0, SR), rtol=0.0, atol=scan_atol)
    hold("adaptive_pre_emphasis", lambda: filters.adaptive_pre_emphasis(pcm),
         lambda: filters.adaptive_pre_emphasis(pcm_cpu), rtol=0.0, atol=scan_atol)
    hold("hilbert_envelope", lambda: temporal.hilbert_envelope(pcm),
         lambda: temporal.hilbert_envelope(pcm_cpu), rtol=0.0, atol="scale:1e-5")
    hold("peak_envelope", lambda: temporal.peak_envelope(pcm), lambda: temporal.peak_envelope(pcm_cpu), 0.0, 0.0)
    hold("crest_factor", lambda: temporal.crest_factor(pcm), lambda: temporal.crest_factor(pcm_cpu))
    hold("energy_statistics", lambda: temporal.energy_statistics(pcm, WINDOW, HOP),
         lambda: temporal.energy_statistics(pcm_cpu, WINDOW, HOP), atol=1e-5)
    tempo = hold("estimate_tempo_range", lambda: temporal.estimate_tempo_range(pcm, SR),
                 lambda: temporal.estimate_tempo_range(pcm_cpu, SR), atol=parity.OPS_RTOL * 240.0)
    frames = frame_signal(pcm, WINDOW, 512)
    hold("detect_voice_activity", lambda: spectral.detect_voice_activity(frames),
         lambda: spectral.detect_voice_activity(frame_signal(pcm_cpu, WINDOW, 512)), 0.0, 0.0)
    segs, res["ms"]["detect_speech_segments_one_clip"] = warm_median_ms(
        lambda: spectral.detect_speech_segments(pcm[3], WINDOW, 512, min_segment_samples=SR // 10),
        SURFACE_ITERS)
    ref_segs = spectral.detect_speech_segments(pcm[3].cpu(), WINDOW, 512, min_segment_samples=SR // 10)
    if not all(np.array_equal(g, r) for g, r in zip(segs, ref_segs, strict=True)):
        raise AssertionError("detect_speech_segments: card and CPU differ")
    lpc = speech.lpc_analyze(pcm[0, :8192], SR, order=16).coefficients
    hold("lpc_residual", lambda: speech.lpc_residual(pcm, lpc),
         lambda: speech.lpc_residual(pcm_cpu, lpc.cpu()), atol=1e-5)

    # -- spectra: K1's [128, 5164, 513] and a full stft for phase
    spec = stft(pcm, WINDOW, HOP, sample_rate=SR, return_phase=True)
    onsets = hold("detect_onsets_complex",
                  lambda: temporal.detect_onsets_complex(spec.magnitude, spec.phase, HOP, SR),
                  lambda: temporal.detect_onsets_complex(spec.magnitude[:rows].cpu(), spec.phase[:rows].cpu(), HOP, SR),
                  0.0, 0.0)
    del spec
    mag_cpu = mag[:rows].cpu()
    hold("mel_spectrum", lambda: mfcc.mel_spectrum(mag, SR, WINDOW), lambda: mfcc.mel_spectrum(mag_cpu, SR, WINDOW),
         atol=1e-5)
    bark = mel.bark_filterbank(24, WINDOW, SR)
    hold("bark_apply_filterbank", lambda: mel.apply_filterbank(mag * mag, bark),
         lambda: mel.apply_filterbank(mag_cpu * mag_cpu, bark), atol=1e-5)
    hold("spectral_contrast_custom_bands", lambda: spectral.spectral_contrast_custom_bands(mag, SR, CUSTOM_BANDS),
         lambda: spectral.spectral_contrast_custom_bands(mag_cpu, SR, CUSTOM_BANDS), atol=1e-4)

    # -- features: the main path's MFCC and chroma of the batch
    frames_mfcc = mfcc_b.reshape(-1, mfcc_b.shape[-1])
    km = clustering.Clustering(num_clusters=8, seed=SEED, device=dev)
    fit, res["ms"]["kmeans_k8"] = warm_median_ms(lambda: km.fit(frames_mfcc), SURFACE_ITERS)
    small = frames_mfcc[: rows * mfcc_b.shape[1]]
    res["kmeans_vs_cpu"] = kmeans_vs_cpu(small, 8, dev)
    res["max_abs_err"]["kmeans_k8"] = res["kmeans_vs_cpu"]["centroid_max_abs"]
    res["kmeans"] = {"frames": int(frames_mfcc.shape[0]), "inertia": fit.inertia,
                     "silhouette": fit.silhouette, "cluster_sizes": np.bincount(fit.labels, minlength=8).tolist()}
    c0 = chroma_b[0]
    hold("distance_matrix_js", lambda: distance.distance_matrix(c0, c0, "js"),
         lambda: distance.distance_matrix(c0[:500].cpu(), c0.cpu(), "js"), rows_of=lambda o: o[:500])
    corpus, src, dups, _ = corpus_rows(DC.layout_size(13))
    corpus_dev = torch.from_numpy(corpus).to(dev)
    (idx, dist) = hold("knn_corpus", lambda: distance.knn(corpus_dev[src], corpus_dev, KNN_K, "manhattan"),
                       lambda: distance.knn(torch.from_numpy(corpus[src]), torch.from_numpy(corpus), KNN_K,
                                            "manhattan"), 0.0, 0.0, rows_of=lambda o: o)
    want = sorted([src, *dups.tolist()])[:KNN_K]
    if idx.tolist() != want or float(dist.abs().max()) != 0.0:
        raise AssertionError(f"knn: {idx.tolist()} at {dist.tolist()}, want the tied copies {want}")
    del corpus_dev
    series = mag[0].sum(-1)                                  # clip 0's spectral energy series
    for name, fn in (("moments_analyze", moments.analyze), ("entropy_analyze", entropy.analyze)):
        got, res["ms"][name] = warm_median_ms(lambda: fn(series), SURFACE_ITERS)
        ref = fn(series.cpu())
        atol = parity.moments_analyze_atol(series.cpu().numpy()) if name == "moments_analyze" else {}
        res["max_abs_err"][name] = max(require(parity_close(
            f"{name}.{k}", got[k], ref[k], parity.MOMENTS_RTOL, atol.get(k, parity.OPS_ATOL)),
            f"{name}.{k}, card vs CPU")[f"{name}.{k}"] for k in ref)
    res["percentiles"] = percentiles.analyze(series.cpu().numpy())
    cent = spectral.spectral_centroid(mag, SR)
    cent_cpu = cent[:rows].cpu()
    row_atol = [parity.moments_analyze_atol(row) for row in cent_cpu.numpy()]
    for name in ("skewness", "kurtosis", "pearson_skewness", "bowley_skewness"):
        hold(f"moments_{name}", lambda: getattr(moments, name)(cent), lambda: getattr(moments, name)(cent_cpu),
             rtol=parity.MOMENTS_RTOL, atol=max(a[name] for a in row_atol))
    hold("histogram_shannon", lambda: entropy.shannon_entropy(entropy.histogram_probs(cent, 64)),
         lambda: entropy.shannon_entropy(entropy.histogram_probs(cent_cpu, 64)))
    chroma_cpu = chroma_b[:rows].cpu()
    hold("chroma_stats", lambda: CA.chroma_stats(chroma_b), lambda: CA.chroma_stats(chroma_cpu), atol=1e-5)
    for name in ("tonal_centroid", "tonnetz_point", "harmonic_tension", "consonance"):
        hold(name, lambda: getattr(CA, name)(chroma_b), lambda: getattr(CA, name)(chroma_cpu), atol=1e-5)
    hold("voice_leading_distance", lambda: CA.voice_leading_distance(chroma_b[:, 1:], chroma_b[:, :-1]),
         lambda: CA.voice_leading_distance(chroma_cpu[:, 1:], chroma_cpu[:, :-1]))
    hold("smooth_chroma", lambda: CA.smooth_chroma(chroma_b[0], 8), lambda: CA.smooth_chroma(chroma_cpu[0], 8),
         rows_of=lambda o: o)
    hold("tonnetz_trajectory", lambda: CA.tonnetz_trajectory(chroma_b[0]), lambda: CA.tonnetz_trajectory(chroma_cpu[0]),
         atol=1e-5, rows_of=lambda o: o)
    del mag, mag_cpu, frames, cent

    # -- chroma sequences: a chord clip and its chroma transposed
    r = torch.roll(q, SURFACE_SHIFT, dims=-1)
    res["sequences"] = {}
    for method in ("direct", "binary", "smith_waterman", "dtw", "qmax", "oti"):
        kw = dict(dtw_band_radius=64) if method == "dtw" else {}
        got, ms = warm_median_ms(lambda: CA.ChromaSequenceSimilarity(method, device=dev, **kw).compute(q, r),
                                 SURFACE_ITERS)
        ref = CA.ChromaSequenceSimilarity(method, device="cpu", **kw).compute(q.cpu(), r.cpu())
        if method == "smith_waterman":
            atol, rtol = parity.SW_ATOL_SCALE * float(np.abs(ref.similarity_matrix).max()), 0.0
        else:
            atol, rtol = parity.OPS_ATOL, parity.OPS_RTOL
        err = require(parity_close(f"{method} matrix", got.similarity_matrix, ref.similarity_matrix, rtol, atol),
                      f"ChromaSequenceSimilarity({method!r}) [{q.shape[0]} x {r.shape[0]}], card vs CPU")
        score_tol = parity.SW_ATOL_SCALE if method == "smith_waterman" else parity.OPS_RTOL
        if abs(got.overall_similarity - ref.overall_similarity) > score_tol * abs(ref.overall_similarity) + 1e-7 \
                or got.best_transposition != ref.best_transposition:
            raise AssertionError(f"{method}: {got.overall_similarity} shift {got.best_transposition} on the card, "
                                 f"{ref.overall_similarity} shift {ref.best_transposition} on the CPU")
        res["ms"][f"sequence_{method}"] = ms
        res["max_abs_err"][f"sequence_{method}"] = err[f"{method} matrix"]
        res["sequences"][method] = {"overall": got.overall_similarity, "shift": got.best_transposition}
    if res["sequences"]["oti"]["shift"] != SURFACE_SHIFT:
        raise AssertionError(f"OTI found shift {res['sequences']['oti']['shift']}, the clip was transposed "
                             f"by {SURFACE_SHIFT}")

    torch.cuda.synchronize()
    res["launches"] = {k: v for k, v in read_launches().items() if v}
    if not res["launches"].get("K1") or not res["launches"].get("K4") or set(res["launches"]) != {"K1", "K4"}:
        raise AssertionError(f"phase 38: the op surface launched {res['launches']}, want K1 and K4 only")
    res["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    res["tempo_bpm_rows_0_3"] = [round(float(v), 3) for v in tempo[0][:4]]
    res["onset_counts_rows_0_3"] = [int(v) for v in onsets[1][:4]]
    res["seconds"] = time.perf_counter() - t0
    slow = sorted(res["ms"].items(), key=lambda kv: -kv[1])[:8]
    log(f"[op surface B={FULL_B} x {FULL_SECONDS} s] {len(res['ms'])} ops held to the CPU on {rows} clips; "
        f"launches {res['launches']}; peak device memory {res['peak_mib']:.0f} MiB; slowest (ms, median of "
        f"{SURFACE_ITERS} after a warm-up) { {k: round(v, 2) for k, v in slow} }; OTI shift "
        f"{res['sequences']['oti']['shift']}; phase {res['seconds']:.1f} s [{card}]")
    return res


MESH_STEPS = 5            # phase 39: timed steps of each configuration, in turns
MESH_STREAM_BATCHES = 3   # phase 39: batches through run_stream over the two-entry pipeline
WARM_CLIP_SECONDS = 60    # phase 40: the cdn_latency-shaped pair

MESH_NCCL_STEP = """
import json, socket, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import torch.distributed as dist
import chip_smoke as C
from sonido_sonar_tpu_torch.config.config import FeatureConfig
from sonido_sonar_tpu_torch.parallel import BatchedFingerprintPipeline, make_mesh, sharded_top_k_matches
from sonido_sonar_tpu_torch.parallel.mesh import initialize_distributed
from sonido_sonar_tpu_torch.parallel.pipeline import batched_fingerprint_features
from sonido_sonar_tpu_torch.utils import parity
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
x = parity.synth_pcm(C.FULL_B, C.FULL_SECONDS * C.SR, C.SEED + 39, C.SR, dev)
cfg = FeatureConfig(sample_rate=C.SR, window_size=C.WINDOW, hop_size=C.HOP)
corpus, src, dups, rng = C.corpus_rows(44)
queries = [rng.standard_normal(44).astype(np.float32), corpus[src]]
want = batched_fingerprint_features(x, sample_rate=C.SR, window_size=C.WINDOW, hop_size=C.HOP)
want_topk = [sharded_top_k_matches(q, corpus, k=C.TOP_K, mesh=None, device=dev) for q in queries]
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
t0 = time.perf_counter()
initialize_distributed(f"127.0.0.1:{port}", 1, 0)
res = {"init_s": time.perf_counter() - t0, "backend": dist.get_backend(),
       "world_size": dist.get_world_size()}
for name, devices in (("one", None), ("two", [dev, dev])):
    mesh = make_mesh(devices=devices)
    got, launches, wall_s = C.counted(lambda: BatchedFingerprintPipeline(mesh, cfg)(x))
    res[name] = {"entries": mesh.size, "distributed": mesh.distributed, "launches": launches,
                 "bit_equal": sorted(got) == sorted(want)
                 and all(torch.equal(got[k], want[k]) for k in want),
                 "max_abs_diff": max(float((got[k] - want[k]).abs().max()) for k in want)}
    tk = [sharded_top_k_matches(q, corpus, k=C.TOP_K, mesh=mesh) for q in queries]
    res[name]["topk_same_indices"] = all(np.array_equal(a[0], b[0]) for a, b in zip(tk, want_topk))
    res[name]["topk_max_score_diff"] = max(float(np.abs(a[1] - b[1]).max())
                                           for a, b in zip(tk, want_topk))
dist.destroy_process_group()
res["destroyed"] = not dist.is_initialized()
print(json.dumps(res))
"""


def run_mesh(card: str, dev: torch.device) -> dict:
    """Phase 39: BatchedFingerprintPipeline at B=128 x 30 s on a one-entry
    mesh (the card) and a two-entry mesh on the one card (a repeated
    entry is a shard that runs after the other): K1 and K2 launched once
    per shard, the features against the unsharded step
    (utils/parity.check_sharded_step: bit for bit, or a key that is not
    held to the whole-path bounds), the host's synchronizations in a
    sharded step (CUDA's sync debug mode), the three steps in turns;
    run_stream over the two-entry pipeline equal to blocking calls;
    sharded_top_k_matches and sharded_batched_similarity over phase 29's
    262,144 rows on both meshes against mesh=None, ms per query; then a
    fresh process with an NCCL group of world size 1 (the global mesh,
    the pipeline and the all-gather merge of the top k against the same
    calls without the group). One H100 holds no NCCL group of two ranks:
    the two-process path is checked on the CPU (tests/test_torch_multihost.py).
    Returns the {"mesh": ...} numbers."""
    from sonido_sonar_tpu_torch.config.config import FeatureConfig
    from sonido_sonar_tpu_torch.fingerprint import device_compare as DC
    from sonido_sonar_tpu_torch.parallel import BatchedFingerprintPipeline, make_mesh, sharded_top_k_matches
    from sonido_sonar_tpu_torch.parallel.pipeline import batched_fingerprint_features, run_stream
    from sonido_sonar_tpu_torch.utils import parity

    t_phase = time.perf_counter()
    cfg = FeatureConfig(sample_rate=SR, window_size=WINDOW, hop_size=HOP)
    x = parity.synth_pcm(FULL_B, FULL_SECONDS * SR, SEED + 39, SR, dev)
    meshes = {"one": make_mesh(devices=None if torch.cuda.device_count() == 1 else [dev]),
              "two": make_mesh(devices=[dev, dev])}
    steps = {"unsharded": lambda: batched_fingerprint_features(x, sample_rate=SR, window_size=WINDOW,
                                                                 hop_size=HOP)}
    want, want_launches, _ = counted(steps["unsharded"])
    res = {"batch": FULL_B, "clip_s": FULL_SECONDS, "unsharded_launches": want_launches}
    for name, mesh in meshes.items():
        pipe = BatchedFingerprintPipeline(mesh, cfg)
        steps[name] = lambda pipe=pipe: pipe(x)
        got, launches, _ = counted(steps[name])
        if launches["K1"] != mesh.size or launches["K2"] != mesh.size:
            raise AssertionError(f"the {mesh.size}-entry mesh launched {launches}, expected K1 and K2 "
                                 f"{mesh.size} times (once per shard)")
        errors = require(parity.check_sharded_step(
            {k: np32(v) for k, v in got.items()}, {k: np32(v) for k, v in want.items()},
            lambda: parity.near_zero_frames(np32(x), WINDOW, HOP, PRE_EMPH), SR, WINDOW),
            f"{name}-entry mesh vs the unsharded step, B={FULL_B} x {FULL_SECONDS} s")
        bit_equal = [k for k in want if torch.equal(got[k], want[k])]
        res[name] = {"entries": mesh.size, "launches": launches, "bit_equal_keys": len(bit_equal),
                     "keys": len(want), "max_abs_diff": max(errors[k] for k in want),
                     "differing_keys": sorted(set(want) - set(bit_equal))}
        log(f"[{name}-entry mesh] launches {launches}; {len(bit_equal)} of {len(want)} keys bit-equal "
            f"to the unsharded step, worst |diff| {res[name]['max_abs_diff']:.3g} "
            f"({res[name]['differing_keys']}) [{card}]")
        del got
    # the host's waits inside a sharded step: each would serialize the
    # shards of a mesh over several cards
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            steps["two"]()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    res["two_step_host_syncs"] = len(syncs)
    log(f"[two-entry mesh] {len(syncs)} host synchronizations in one step (CUDA sync debug mode): "
        f"{sorted(set(syncs))[:4]}")
    times = {name: [] for name in steps}
    for _ in range(MESH_STEPS):
        for name, fn in steps.items():
            times[name] += timed_steps(fn, 1)
    for name, step_s in times.items():
        res[f"{name}_ms"] = report_steps(f"{name} step B={FULL_B} x {FULL_SECONDS} s (in turns)",
                                         step_s, FULL_B * FULL_SECONDS, card)
        res[f"{name}_steps_ms"] = [1e3 * s for s in step_s]
        res[f"{name}_audio_h_per_wall_h"] = FULL_B * FULL_SECONDS / float(np.mean(step_s))
    torch.cuda.empty_cache()

    pipe = BatchedFingerprintPipeline(meshes["two"], cfg)
    batches = [x * (1.0 - 0.03 * k) for k in range(MESH_STREAM_BATCHES)]
    got, launches, _ = counted(lambda: list(run_stream(pipe, batches, drain_every=2, device=dev)))
    if len(got) != len(batches):
        raise AssertionError(f"run_stream yielded {len(got)} results for {len(batches)} batches")
    for k, b in enumerate(batches):
        direct = pipe(b)
        bad = [key for key in direct if not torch.equal(got[k][key], direct[key])]
        if bad:
            raise AssertionError(f"run_stream over the pipeline, batch {k}: {bad} differ")
    res["run_stream"] = {"batches": len(batches), "launches": launches, "bit_equal": True}
    log(f"[run_stream over the two-entry pipeline] {len(batches)} batches equal to blocking calls, "
        f"in order; launches {launches}")
    del got, batches, x
    torch.cuda.empty_cache()

    corpus, src, dups, rng = corpus_rows(DC.layout_size(13))
    X = torch.from_numpy(corpus).to(dev)
    mcorpus = X[:, :44].contiguous()              # the matcher's packed layout
    w = np.array([0.35, 0.25, 0.10, 0.20, 0.10, 0.10], np.float32)
    match = torch.ones(CORPUS_ROWS, dtype=torch.bool, device=dev)
    queries = {"random": rng.standard_normal(DC.layout_size(13)).astype(np.float32),
               "tied": corpus[src]}
    tied = sorted([src, *dups.tolist()])[:TOP_K]
    for label, q in queries.items():
        ref = sharded_top_k_matches(q[:44], mcorpus, k=2 * TOP_K, mesh=None)
        ref_sim = DC.sharded_batched_similarity(q, X, w, match, num_mfcc_coeffs=13)
        for name, mesh in [("none", None), *meshes.items()]:
            def topk():
                return sharded_top_k_matches(q[:44], mcorpus, k=TOP_K, mesh=mesh)

            def similarity():
                return DC.sharded_batched_similarity(q, X, w, match, mesh=mesh, num_mfcc_coeffs=13)

            (idx, scores), t_topk = warm_median_ms(topk, 5)
            sim, t_sim = warm_median_ms(similarity, 5)
            runs = _same_ranking(f"sharded_top_k_matches, {label} query, {name} mesh", idx.tolist(),
                                 scores.tolist(), ref[0].tolist(), ref[1].tolist())
            if label == "tied" and idx.tolist() != tied:
                raise AssertionError(f"{name} mesh: the tied rows are not lowest index first: "
                                     f"{idx.tolist()}, expected {tied}")
            err = max(float(np.abs(sim[k] - ref_sim[k]).max()) for k in ("overall", "confidence"))
            same = all(np.array_equal(sim[k], ref_sim[k]) for k in ("match_class", "feature_present"))
            if not (err <= parity.COMPARATOR_HOST_ATOL and same and len(sim["overall"]) == CORPUS_ROWS):
                raise AssertionError(f"sharded_batched_similarity, {name} mesh: |diff| {err:.3g}, "
                                     f"classes and gates equal {same}")
            res[f"search_{label}_{name}"] = {"topk_ms": t_topk, "similarity_ms": t_sim,
                                             "tied_runs": runs, "similarity_err": err}
            log(f"[corpus C = {CORPUS_ROWS}, {label} query, {name} mesh] sharded_top_k_matches "
                f"{t_topk:.3f} ms, sharded_batched_similarity {t_sim:.3f} ms a query (blocking, "
                f"to the host); the ranking of mesh=None ({runs} tied runs), |diff| {err:.3g} "
                f"[{card}]")
    del X, mcorpus, match
    torch.cuda.empty_cache()

    proc = subprocess.run([sys.executable, "-c", MESH_NCCL_STEP, str(Path(__file__).resolve().parent)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the NCCL world-size-1 run failed: {proc.stderr[-3000:]}")
    nccl = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"[NCCL group of world size 1, a fresh process] {nccl}")
    for name, size in (("one", 1), ("two", 2)):
        r = nccl[name]
        if not (r["bit_equal"] and r["topk_same_indices"] and r["distributed"]
                and r["topk_max_score_diff"] <= parity.COMPARATOR_HOST_ATOL
                and r["launches"]["K1"] == r["launches"]["K2"] == size):
            raise AssertionError(f"the NCCL run's {name}-entry mesh: {r}")
    if nccl["backend"] != "nccl" or nccl["world_size"] != 1 or not nccl["destroyed"]:
        raise AssertionError(f"the NCCL run: {nccl}")
    res["nccl_world_size_1"] = nccl
    res["phase_s"] = time.perf_counter() - t_phase
    return res


WARM_FIRST = """
import json, sys, time
t0 = time.perf_counter()
sys.path.insert(0, sys.argv[1])
import torch
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke as C
from sonido_sonar_tpu_torch import _build
from sonido_sonar_tpu_torch.warmup import cache_hit_counter, warmup
hits = cache_hit_counter()
import_s = time.perf_counter() - t0
rep = warmup(cache_dir=sys.argv[2], batch_sizes=(C.FULL_B,), clip_seconds=(C.FULL_SECONDS,),
             components=("fingerprint", "alignment", "search"), alignment_pairs=(1, 32),
             corpus_sizes=(C.CORPUS_ROWS,))
info = _build.build()[1]
print(json.dumps({"import_s": import_s, "stages_s": rep, "hits": hits(), "nvcc_s": info.seconds,
                  "library": str(info.path), "wall_s": time.perf_counter() - t0}))
"""

WARM_AGAIN = """
import json, sys, time
t0 = time.perf_counter()
sys.path.insert(0, sys.argv[1])
import torch
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke as C
from sonido_sonar_tpu_torch import _build
from sonido_sonar_tpu_torch.examples import cdn_latency
from sonido_sonar_tpu_torch.warmup import cache_hit_counter, enable_persistent_cache, warmup
hits = cache_hit_counter()
res = {"import_s": time.perf_counter() - t0, "warmed": sys.argv[3] == "warm"}
t = time.perf_counter()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
res["context_s"] = time.perf_counter() - t
t = time.perf_counter()
enable_persistent_cache(sys.argv[2])
info = _build.build()[1]
res.update(load_s=time.perf_counter() - t, nvcc_s=info.seconds, library=str(info.path))
if res["warmed"]:
    res["stages_s"] = warmup(batch_sizes=(1,), clip_seconds=(C.WARM_CLIP_SECONDS,),
                             components=("fingerprint", "alignment"), alignment_pairs=(1,),
                             window_seconds=C.WARM_CLIP_SECONDS, max_lag_seconds=C.LATENCY_BUDGET)
calls = []
for _ in range(2):
    t = time.perf_counter()
    out = cdn_latency.main(sys.argv[4], sys.argv[5], C.LATENCY_BUDGET)
    calls.append(1e3 * (time.perf_counter() - t))
res.update(calls_ms=calls, latency_s=out["latency_s"], hits=hits(),
           wall_s=time.perf_counter() - t0)
print(json.dumps(res))
"""


def run_warmup(card: str) -> dict:
    """Phase 40: three fresh processes sharing one temporary cache_dir.
    The first runs warmup(cache_dir=...) with the fingerprint, alignment
    and search components at B=128 x 30 s, alignment pairs (1, 32) and a
    262,144-row corpus: nvcc runs into the directory, no cache hit. The
    second loads the library from it without nvcc (one hit), warms the
    cdn_latency shape (one 60 s clip, one pair) and times two
    examples.cdn_latency calls on a 60 s speech pair; the third loads the
    library the same way and times the same two calls without a warm-up.
    Each process initializes its CUDA context before the timed part, so
    the first calls differ by what warmup primes (cuFFT plans, cuBLAS
    handles, the caching allocator). Returns the {"warmup": ...} numbers."""
    from sonido_sonar_tpu_torch.io.decode import write_wav
    from sonido_sonar_tpu_torch.io.synth import shift_signal, speech_like

    here = str(Path(__file__).resolve().parent)
    res = {}
    with tempfile.TemporaryDirectory(prefix="sonido_warm_") as tmp:
        cache = str(Path(tmp) / "kernels")
        src = speech_like(WARM_CLIP_SECONDS, SR, seed=SEED + 200, random_syllables=True)
        sp, cp = str(Path(tmp) / "src.wav"), str(Path(tmp) / "cdn.wav")
        write_wav(sp, src, SR)
        write_wav(cp, shift_signal(src, LATENCY_LAG, noise=0.02, gain=0.9), SR)
        for name, script, args in (("first", WARM_FIRST, [cache]),
                                   ("warmed", WARM_AGAIN, [cache, "warm", sp, cp]),
                                   ("cold", WARM_AGAIN, [cache, "cold", sp, cp])):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-c", script, here, *args], capture_output=True,
                                  text=True, timeout=900)
            if proc.returncode != 0:
                raise AssertionError(f"phase 40, the {name} process failed: {proc.stderr[-3000:]}")
            res[name] = {**json.loads(proc.stdout.strip().splitlines()[-1]),
                         "process_s": time.perf_counter() - t0}
            log(f"[warmup, the {name} process] {res[name]} [{card}]")
    first, warmed, cold = res["first"], res["warmed"], res["cold"]
    if not (first["hits"] == 0 and first["nvcc_s"] > 0 and Path(first["library"]).parent.name == "kernels"):
        raise AssertionError(f"the first process did not build into the cache dir: {first}")
    for r in (warmed, cold):
        if not (r["hits"] == 1 and r["nvcc_s"] == 0.0 and r["library"] == first["library"]):
            raise AssertionError(f"a later process did not load the library from the cache: {r}")
        if not abs(r["latency_s"] - LATENCY_LAG / SR) <= HOP / SR:
            raise AssertionError(f"cdn_latency after the cache load: latency {r['latency_s']}")
    log(f"[warmup] the first process: nvcc {first['nvcc_s']:.1f} s, stages "
        + ", ".join(f"{k} {v:.2f} s" for k, v in first["stages_s"].items())
        + f"; a later process loads the library in {warmed['load_s']:.3f} s (no nvcc, hit count "
        f"{warmed['hits']}); cdn_latency first/second call {warmed['calls_ms'][0]:.1f}/"
        f"{warmed['calls_ms'][1]:.1f} ms after warmup ({sum(warmed['stages_s'].values()):.2f} s), "
        f"{cold['calls_ms'][0]:.1f}/{cold['calls_ms'][1]:.1f} ms without [{card}]")
    return res


def main() -> int:
    here = Path(__file__).resolve().parent
    card = card_line()                                        # phase 1
    log(card)
    if not torch.cuda.is_available():                         # phase 2
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import sonido_sonar_tpu_torch as port

    if Path(port.__file__).resolve().parent.parent != here:
        raise SystemExit(f"chip_smoke: imported the port from {port.__file__}, not {here}")
    from sonido_sonar_tpu_torch import _build
    from sonido_sonar_tpu_torch.config.config import FeatureConfig, FingerprintConfig
    from sonido_sonar_tpu_torch.fingerprint import FingerprintGenerator
    from sonido_sonar_tpu_torch.io.audio import AudioData, AudioMetadata
    from sonido_sonar_tpu_torch.ops import hopper_contrast, hopper_onsets, hopper_stft, hopper_yin
    from sonido_sonar_tpu_torch.ops import temporal as T
    from sonido_sonar_tpu_torch.ops.filters import dc_removal, pre_emphasis_for_content
    from sonido_sonar_tpu_torch.ops.stft import spectral_flux
    from sonido_sonar_tpu_torch.parallel.pipeline import (
        batched_fingerprint_features,
        batched_music_extractor_features,
        batched_speech_extractor_features,
    )
    from sonido_sonar_tpu_torch.utils import parity
    from sonido_sonar_tpu_torch.utils.convert import features_to_numpy, flatten_features

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    lib, info = _build.build()                                # phase 3
    log(f"built {info.path.name} in {info.seconds:.1f} s")
    log(info.compiler_log.strip())
    for name, features in (("K1", 0), ("K10", 1)):
        smem, blocks = ctypes.c_int(), ctypes.c_int()
        code = lib.sonido_stft_occupancy(WINDOW, HOP, features, ctypes.byref(smem),
                                         ctypes.byref(blocks))
        if code != 0:
            raise AssertionError(f"{name} occupancy query failed: {lib.sonido_error_string(code)}")
        log(f"{name} at {WINDOW}/{HOP}: {smem.value} B of shared memory per block, "
            f"{blocks.value} blocks per SM [{card}]")
    regs, local, smem, blocks = (ctypes.c_int() for _ in range(4))
    out4 = [ctypes.byref(v) for v in (regs, local, smem, blocks)]
    code = lib.sonido_thin_onsets_occupancy(*out4)
    if code != 0:
        raise AssertionError(f"K4 occupancy query failed: {lib.sonido_error_string(code)}")
    log(f"K4: {regs.value} registers, {local.value} B of local memory (spills), {smem.value} B of "
        f"shared memory per block, {blocks.value} blocks per SM [{card}]")
    from sonido_sonar_tpu_torch.ops.hopper_contrast import band_plan
    from sonido_sonar_tpu_torch.ops.spectral import contrast_band_edges, spectral_contrast
    for what, keys, f_bins in (
        ("lane plan", band_plan(contrast_band_edges(6, WINDOW // 2 + 1, SR), WINDOW // 2 + 1)[1],
         WINDOW // 2 + 1),
        ("general form", 0, WINDOW // 2 + 1),
    ):
        code = lib.sonido_contrast_occupancy(keys, f_bins, *out4)
        if code != 0:
            raise AssertionError(f"K9 occupancy query failed: {lib.sonido_error_string(code)}")
        log(f"K9 {what} ({keys} keys a lane) at F = {f_bins}: {regs.value} registers, {local.value} B "
            f"of local memory (spills), {smem.value} B of shared memory per block, {blocks.value} "
            f"blocks per SM [{card}]")
    for name, w, hop, rows in (("K2", PITCH_WINDOW, PITCH_HOP, 0), ("K2 amp", 1024, 256, 0),
                               ("K3", PITCH_WINDOW, PITCH_HOP, 1)):
        smem, blocks = ctypes.c_int(), ctypes.c_int()
        code = lib.sonido_yin_occupancy(w, hop, rows, ctypes.byref(smem), ctypes.byref(blocks))
        if code != 0:
            raise AssertionError(f"{name} occupancy query failed: {lib.sonido_error_string(code)}")
        log(f"{name} at {w}/{hop}: {smem.value} B of shared memory per block, "
            f"{blocks.value} blocks per SM [{card}]")

    k1 = hopper_stft.stft_magnitude_hopper
    k1_plain = hopper_stft.stft_magnitude_plain
    k2 = hopper_yin.yin_pitch_hopper
    k2_plain = hopper_yin.yin_pitch_plain
    k2_args = (PITCH_WINDOW, PITCH_HOP, SR, 80.0, 1000.0, 0.15, PRE_EMPH)
    k9 = hopper_contrast.band_select_means_hopper

    def hold_k1(x, w, hop, pre):
        near = parity.near_zero_frames(np32(x), w, hop, pre)
        mag, aux = k1(x, w, hop, pre_emph=pre)
        pmag, paux = k1_plain(x, w, hop, pre_emph=pre)
        torch.cuda.synchronize()
        return require(parity.check_stft_aux(
            np32(mag), {k: np32(v) for k, v in aux.items()},
            np32(pmag), {k: np32(v) for k, v in paux.items()}, near,
        ), f"K1 vs plain, {tuple(x.shape)}, W={w}, hop={hop}, pre={pre}")

    def hold_k2(x, w, hop, pre):
        args = (w, hop, SR, 80.0, 1000.0, 0.15, pre)
        p, c, v = k2(x, *args)
        pp, pc, _ = k2_plain(x, *args)
        torch.cuda.synchronize()
        errors = require(parity.check_pitch(np32(p), np32(c), np32(pp), np32(pc)),
                         f"K2 vs plain, {tuple(x.shape)}, W={w}, hop={hop}, pre={pre}")
        if not torch.equal(v, c):
            raise AssertionError("K2: voicing is not the confidence")
        both = (np32(p) > 0) & (np32(pp) > 0)
        errors["pitch_max_abs"] = float(np.abs(np32(p) - np32(pp))[both].max(initial=0.0))
        return errors

    small = parity.synth_pcm(SMALL_B, SMALL_SECONDS * SR, SEED, SR, dev)
    full = parity.synth_pcm(FULL_B, FULL_SECONDS * SR, SEED + 1, SR, dev)
    torch.cuda.synchronize()
    errs = {}
    for name, x in (("small", small), ("full", full)):        # phases 4, 5
        errs["K1", name] = hold_k1(x, WINDOW, HOP, PRE_EMPH)
        errs["K2", name] = hold_k2(x, PITCH_WINDOW, PITCH_HOP, PRE_EMPH)
        torch.cuda.empty_cache()
    # the kernels' other geometries and options, an odd hop (frames off
    # 8-byte alignment), and a 1-D row
    odd = parity.synth_pcm(3, SR + 777, SEED + 3, SR, dev)
    for w, hop, pre in ((512, 128, 0.0), (2048, 512, 0.95), (256, 100, 0.97),
                        (1024, 255, PRE_EMPH)):
        hold_k1(odd, w, hop, pre)
        hold_k2(odd, w, hop, pre)
        hold_k3(odd, w, hop)
    # K1's smallest FFT instances
    for w, hop, pre in ((64, 32, PRE_EMPH), (128, 64, 0.0)):
        hold_k1(odd, w, hop, pre)
    mag1, aux1 = k1(odd[1], WINDOW, HOP, pre_emph=PRE_EMPH)
    mag3, aux3 = k1(odd, WINDOW, HOP, pre_emph=PRE_EMPH)
    p1 = k2(odd[1], *k2_args)[0]
    if not (torch.equal(mag1, mag3[1]) and torch.equal(aux1["rms"], aux3["rms"][1])
            and torch.equal(p1, k2(odd, *k2_args)[0][1])):
        raise AssertionError("a 1-D row and the same row in a batch differ")
    log("[K1, K2 on a 1-D row] equal to the same row in a batch")

    t_frames = (FULL_SECONDS * SR - WINDOW) // HOP + 1        # phase 6
    t_pitch = (FULL_SECONDS * SR - PITCH_WINDOW) // PITCH_HOP + 1
    k1.launches = k2.launches = k9.launches = 0
    out = batched_fingerprint_features(full, sample_rate=SR, window_size=WINDOW, hop_size=HOP)
    torch.cuda.synchronize()
    launches = {"K1": k1.launches, "K2": k2.launches, "K9": k9.launches}
    log(f"main path launches: {launches}")
    if launches != {"K1": 1, "K2": 1, "K9": 1}:
        raise AssertionError(f"the main path launched {launches}, expected K1 1, K2 1, K9 1")
    expect = {"mfcc": (t_frames, 13), "chroma": (t_frames, 12),
              "spectral_contrast": (t_frames, 6), "energy_variance": (),
              "pitch": (t_pitch,), "pitch_confidence": (t_pitch,), "voicing": (t_pitch,)}
    if sorted(out) != sorted(OUTPUT_KEYS):
        raise AssertionError(f"outputs {sorted(out)}, expected {sorted(OUTPUT_KEYS)}")
    for key, v in out.items():
        shape = (FULL_B,) + expect.get(key, (t_frames,))
        if tuple(v.shape) != shape or v.dtype != torch.float32:
            raise AssertionError(f"{key}: {v.dtype}{tuple(v.shape)}, expected float32{shape}")
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{key}: non-finite values")
    voiced = float((out["pitch"] > 0).float().mean())
    log(f"main path outputs: {len(out)} keys, shapes and dtypes as expected, all finite; "
        f"voiced share {voiced:.3f}")
    # its contrast is K9's on its own magnitudes, and near the sorts' (the plain version)
    mag = k1(full, WINDOW, HOP, pre_emph=PRE_EMPH)[0]
    if not torch.equal(spectral_contrast(mag, SR, 6), out["spectral_contrast"]):
        raise AssertionError("the main path's contrast is not spectral_contrast of its magnitudes")
    peak, valley = hopper_contrast.band_select_means_plain(mag, contrast_band_edges(6, mag.shape[-1], SR))
    sorted_db = torch.where(peak > 0, 10.0 * torch.log10(peak / torch.clamp_min(valley, 1e-10)), 0.0)
    contrast_gap_db = float((out["spectral_contrast"] - sorted_db).abs().max())
    log(f"main path contrast: K9 against the sorts, largest gap {contrast_gap_db:.6g} dB "
        f"over {tuple(sorted_db.shape)}")
    if contrast_gap_db > CONTRAST_GAP_DB:
        raise AssertionError(f"main path contrast {contrast_gap_db} dB from the sorts' "
                             f"(limit {CONTRAST_GAP_DB})")
    del out, mag, peak, valley, sorted_db
    torch.cuda.empty_cache()
    step_s = []
    for _ in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batched_fingerprint_features(full, sample_rate=SR, window_size=WINDOW, hop_size=HOP)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    ms = 1e3 * float(np.mean(step_s))
    audio_h_per_h = FULL_B * FULL_SECONDS / float(np.mean(step_s))
    log(f"main path B={FULL_B} x {FULL_SECONDS} s: {ms:.2f} ms/step "
        f"(steps {', '.join(f'{1e3 * s:.2f}' for s in step_s)}), "
        f"{audio_h_per_h:.0f} audio-h per wall-h [{card}]")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    pcm2 = parity.synth_pcm(2, SR, SEED + 2, SR)                    # phase 7
    on_card = batched_fingerprint_features(pcm2.to(dev))
    on_cpu = batched_fingerprint_features(pcm2)
    near2 = parity.near_zero_frames(pcm2.numpy(), WINDOW, HOP, PRE_EMPH)
    require(parity.check_features(
        {k: np32(v) for k, v in on_card.items()}, {k: v.numpy() for k, v in on_cpu.items()},
        near2, SR, WINDOW,
    ), "main path [2, 44100], card vs CPU")
    pcm16 = parity.synth_pcm(2, 16000, SEED + 3, 16000)
    on_card = batched_fingerprint_features(pcm16.to(dev), sample_rate=16000)
    on_cpu = batched_fingerprint_features(pcm16, sample_rate=16000)
    near16 = parity.near_zero_frames(pcm16.numpy(), WINDOW, HOP, PRE_EMPH)
    require(parity.check_features(
        {k: np32(v) for k, v in on_card.items()}, {k: v.numpy() for k, v in on_cpu.items()},
        near16, 16000, WINDOW,
    ), "main path [2, 16000] at 16 kHz, card vs CPU (ZCR exact)")
    log(f"[main path at 16 kHz] ZCR bit-equal on "
        f"{int((np32(on_card['zcr']) == on_cpu['zcr'].numpy()).sum())} of {near16.size} frames "
        f"({int(near16.sum())} exempt: a sample near 0)")

    times = {}                                                # phase 8
    for name, kern, plain, args in (
        ("K1", k1, k1_plain, (WINDOW, HOP, "hann", PRE_EMPH)),
        ("K2", k2, k2_plain, k2_args),
    ):
        times[name] = in_turns(lambda: kern(full, *args), lambda: plain(full, *args), 10)
        log(f"{name} at {tuple(full.shape)}: kernel {times[name][0]:.3f} ms, "
            f"plain {times[name][1]:.3f} ms [{card}]")
        torch.cuda.empty_cache()
    frames_k1 = FULL_B * t_frames
    bounds = {
        "K1": bound(full.numel() * 4 + frames_k1 * (WINDOW // 2 + 1 + 5) * 4,
                    frames_k1 * stft_ops(WINDOW)),
        "K2": bound(full.numel() * 4 + FULL_B * t_pitch * 2 * 4,
                    FULL_B * t_pitch * (yin_ops(PITCH_WINDOW) + 10 * PITCH_WINDOW // 2)),
        "K2amp": bound(full.numel() * 4 + frames_k1 * 3 * 4,
                       frames_k1 * (yin_ops(1024) + 10 * 1024 // 2)),
        "K10": bound(full.numel() * 4 + frames_k1 * (WINDOW // 2 + 1 + 5 + 43) * 4,
                     frames_k1 * (stft_ops(WINDOW) + 15 * (WINDOW // 2 + 1)
                                  + 2 * hopper_stft.feature_tables(WINDOW // 2 + 1, SR, WINDOW)[1].size)),
    }

    fslice = run_features(card, dev, full, small)            # phases 23-27

    k4 = hopper_onsets.thin_onsets_hopper
    k4_plain = hopper_onsets.thin_onsets_plain
    n_full = FULL_SECONDS * SR

    def hold_k2_amp(x):                                       # phase 9
        p, c, v, a = k2(x, *VQ_ARGS, with_period_amp=True)
        pp, pc, _, pa = k2_plain(x, *VQ_ARGS, with_period_amp=True)
        torch.cuda.synchronize()
        what = f"K2 with period amplitude vs plain, {tuple(x.shape)}"
        errors = require(parity.check_pitch(np32(p), np32(c), np32(pp), np32(pc)), what)
        errors.update(require(parity.check_period_amp(np32(a), np32(pa)), what + ", amplitude"))
        both = (np32(p) > 0) & (np32(pp) > 0)
        errors["amp_max_abs"] = float(np.abs(np32(a) - np32(pa))[both].max(initial=0.0))
        if not torch.equal(v, c):
            raise AssertionError("K2: voicing is not the confidence")
        return errors

    small_sp = pre_emphasis_for_content(small, "speech").contiguous()
    full_sp = pre_emphasis_for_content(full, "speech").contiguous()
    hold_k2_amp(small_sp)
    errs["K2amp", "full"] = hold_k2_amp(full_sp)
    torch.cuda.empty_cache()

    def hold_k4(cand, min_frames, what):                      # phase 10
        got, ref = k4(cand, min_frames), k4_plain(cand, min_frames)
        torch.cuda.synchronize()
        if got.dtype != torch.bool or got.shape != cand.shape or not torch.equal(got, ref):
            bad = int((got != ref).sum()) if got.shape == ref.shape else -1
            raise AssertionError(f"K4 vs plain, {what}: {bad} elements differ")
        return int(got.sum())

    rng = np.random.default_rng(SEED + 4)
    t_flux = (n_full - WINDOW) // HOP + 1       # flux onsets at hop 256
    t_energy = (n_full - 512) // 256 + 1        # tempo's energy onsets, 512/256
    t_tempo = (n_full - 1024) // 512 + 1        # tempo's flux onsets, hop 512
    k4_checked = 0
    # the three calls' T, and T one frame longer (5165 and 5167)
    for t in sorted({t_flux, t_energy, t_tempo, t_flux + 1, t_energy + 1}):
        for density in (0.05, 0.3):
            cand = torch.from_numpy(rng.random((FULL_B, t)) < density).to(dev)
            for mf in (8, 4):
                kept = hold_k4(cand, mf, f"[{FULL_B}, {t}] at {density}, min_frames {mf}")
                k4_checked += 1
    mag_m, _ = k1(full, WINDOW, HOP)
    real = T.flux_onset_candidates(spectral_flux(mag_m), 0.3).contiguous()
    del mag_m
    kept = hold_k4(real, 8, f"the music path's flux candidates {tuple(real.shape)}")
    bounds["K4"] = bound(2 * real.numel(), real.numel())
    odd_c = torch.from_numpy(rng.random((3, 777)) < 0.3).to(dev)
    hold_k4(odd_c, 1, "[3, 777]")
    hold_k4(torch.from_numpy(rng.random((2, 3, t_tempo)) < 0.3).to(dev), 4, "[2, 3, T]")
    # the skip-ahead walk's edges: a skip that crosses words (40), one
    # frame (1), full and empty rows, a lone candidate at T - 1, odd T
    # with leading axes; each also against the numpy model of the plan
    edge = torch.from_numpy(rng.random((FULL_B, t_flux)) < 0.3)
    edge[1] = False
    edge[2] = True
    edge[3, :] = False
    edge[3, -1] = True
    odd = torch.from_numpy(rng.random((2, 3, 5163)) < 0.1)
    long_rows = torch.from_numpy(rng.random((4, 40000)) < 0.01)  # three tiles
    # the walk carried from one tile into the next, on the masked path
    # (min_frames 1, 8, 40) and the seek path (100): row 0 keeps the frame
    # just before each tile edge, then a run of candidates across it; row
    # 1 is random; row 2 holds dense runs across the edges; row 3 keeps
    # the two frames just before each edge and T - 1
    tiles = torch.from_numpy(rng.random((4, 40000)) < 0.3)
    tiles[0] = False
    tiles[2] = torch.from_numpy(rng.random(40000) < 0.02)
    tiles[3] = False
    for e in (hopper_onsets.TILE, 2 * hopper_onsets.TILE):
        tiles[0, e - 1:e + 121] = True
        tiles[2, e - 200:e + 200] = torch.from_numpy(rng.random(400) < 0.5)
        tiles[3, e - 2:e] = True
    tiles[3, -1] = True
    holds = [(edge, 40, "min_frames 40"), (edge, 1, "min_frames 1"), (edge, 8, "min_frames 8"),
             (odd, 8, "[2, 3, 5163]"), (long_rows, 20000, "min_frames past a tile")]
    holds += [(tiles, mf, f"across tile edges, min_frames {mf}") for mf in (1, 8, 40, 100)]
    for cand, mf, what in holds:
        got_edge = k4(cand.to(dev), mf).cpu().numpy()
        hold_k4(cand.to(dev), mf, f"{tuple(cand.shape)}, {what}")
        if not np.array_equal(got_edge, hopper_onsets.thin_onsets_model(cand.numpy(), mf)):
            raise AssertionError(f"K4 differs from the numpy model of its plan, {what}")
        if cand is tiles and not all(bool(got_edge[0, e - 1]) for e in (hopper_onsets.TILE,
                                                                         2 * hopper_onsets.TILE)):
            raise AssertionError(f"K4 {what}: the frame before a tile edge was not kept")
        k4_checked += 1
    log(f"[K4 vs plain] bit-identical on {k4_checked + 3} inputs (the last {len(holds)} also "
        f"equal to the numpy model); the real flux candidates {int(real.sum())} -> {kept} kept")

    six = parity.synth_pcm(6, SR + 777, SEED + 5, SR, dev)    # phase 11
    m6, a6 = k1(six, WINDOW, HOP, pre_emph=PRE_EMPH)
    m23, a23 = k1(six.view(2, 3, -1), WINDOW, HOP, pre_emph=PRE_EMPH)
    same = torch.equal(m23.reshape(m6.shape), m6) and all(
        torch.equal(a23[k].reshape(a6[k].shape), a6[k]) for k in a6)
    for amp in (False, True):
        y6 = k2(six, *VQ_ARGS, with_period_amp=amp)
        y23 = k2(six.view(2, 3, -1), *VQ_ARGS, with_period_amp=amp)
        same = same and all(torch.equal(q.reshape(r.shape), r) for q, r in zip(y23, y6))
    if not same or m23.shape[:2] != (2, 3):
        raise AssertionError("[2, 3, N] through K1/K2 differs from the same rows as [6, N]")
    log("[K1, K2 on [2, 3, N]] equal to the same rows as [6, N]")
    del six, m6, a6, m23, a23, small_sp
    torch.cuda.empty_cache()

    # phase 12: the public generator path at full width
    gen_cfg = FingerprintConfig(feature_config=FeatureConfig(sample_rate=SR, window_size=WINDOW,
                                                             hop_size=HOP))
    clips = parity.harmonic_clips(FULL_B, n_full, SEED + 6, SR, 196.0, dev)
    news = [AudioData(pcm=clips[i], sample_rate=SR,
                      metadata=AudioMetadata(extra={"content_type": "news"}))
            for i in range(FULL_B)]
    gen = FingerprintGenerator(gen_cfg)

    def gen_step():
        return gen.generate_fingerprints_batch(news, pcm_matrix=clips, materialize=False)

    k1.launches = k2.launches = k2.amp_launches = 0
    batch = gen_step()
    torch.cuda.synchronize()
    gen_launches = {"K1": k1.launches, "K2": k2.launches, "K2amp": k2.amp_launches}
    log(f"generator (news) launches: {gen_launches}")
    if gen_launches["K1"] < 1 or gen_launches["K2"] < 2 or gen_launches["K2amp"] < 1:
        raise AssertionError(f"the generator path missed a kernel: {gen_launches}")
    (ct, idxs, feats), = batch.groups
    if ct.value != "news" or len(idxs) != FULL_B:
        raise AssertionError(f"generator grouped {ct} x {len(idxs)}")
    check_surface("generator news", flatten_features(feats), news_schema(FULL_B, n_full), NEWS_INTS)
    fps = batch.materialize()
    one = features_to_numpy(fps[-1].features)
    for k, shape in news_schema(FULL_B, n_full).items():
        if one[k].shape != shape[1:]:
            raise AssertionError(f"materialized {k}: {one[k].shape}, expected {shape[1:]}")
    log(f"[generator news] materialized {len(fps)} fingerprints of the schema's shapes")
    comparator = run_comparator(card, dev, batch, fps, gen_step, {"K1": k1, "K2": k2})  # 28-29
    del batch, fps, feats
    gen_ms = report_steps(f"generator news B={FULL_B} x {FULL_SECONDS} s", timed_steps(gen_step, SURFACE_STEPS),
                          FULL_B * FULL_SECONDS, card)
    clips2 = parity.harmonic_clips(FULL_B, n_full, SEED + 7, SR, 220.0, dev)
    plain_audios = [AudioData(pcm=clips2[i], sample_rate=SR) for i in range(FULL_B)]
    k1.launches = k2.launches = k2.amp_launches = k4.launches = 0
    fps2 = gen.generate_fingerprints_batch(plain_audios, pcm_matrix=clips2)
    torch.cuda.synchronize()
    types = sorted({f.content_type.value for f in fps2})
    log(f"[generator, no metadata] detected {types}; launches K1 {k1.launches}, K2 {k2.launches} "
        f"(period amplitude {k2.amp_launches}), K4 {k4.launches} (a speculation on the last "
        f"batch's type that detection overrules runs a second extractor)")
    del fps2, clips2, plain_audios
    torch.cuda.empty_cache()

    def music_step():                                         # phase 13
        return batched_music_extractor_features(clips, SR, WINDOW, HOP)

    k1.launches = k4.launches = k9.launches = 0
    mus = music_step()
    torch.cuda.synchronize()
    music_launches = {"K1": k1.launches, "K4": k4.launches, "K9": k9.launches}
    log(f"music program launches: {music_launches}")
    if music_launches != {"K1": 2, "K4": 3, "K9": 1}:
        raise AssertionError(f"the music path launched {music_launches}, expected K1 2, K4 3, K9 1")
    check_surface("music program", mus, music_schema(FULL_B, n_full), MUSIC_INTS)
    log(f"[music program] onsets per clip {float(mus['onset_mask'].sum(-1).float().mean()):.1f}, "
        f"tempo {sorted(set(mus['tempo_bpm'].tolist()))}")
    del mus
    music_ms = report_steps(f"music program B={FULL_B} x {FULL_SECONDS} s",
                            timed_steps(music_step, SURFACE_STEPS), FULL_B * FULL_SECONDS, card)
    k1.launches = k2.launches = k2.amp_launches = 0
    sp = batched_speech_extractor_features(clips, SR, WINDOW, HOP)
    torch.cuda.synchronize()
    log(f"speech extractor launches: K1 {k1.launches}, K2 {k2.launches} "
        f"(period amplitude {k2.amp_launches})")
    check_surface("speech extractor", sp, {"pitch": (FULL_B, (n_full - 1024) // 512 + 1)},
                  {"formant_count": torch.int32, "pause_count": torch.int32, "is_speech": torch.bool})
    del sp
    report_steps(f"speech extractor B={FULL_B} x {FULL_SECONDS} s",
                 timed_steps(lambda: batched_speech_extractor_features(clips, SR, WINDOW, HOP),
                             SURFACE_STEPS), FULL_B * FULL_SECONDS, card)
    torch.cuda.empty_cache()

    small_clips = torch.cat([parity.harmonic_clips(1, SR, SEED + 8), parity.voiced_pcm(1, SR, SEED + 9)])
    for label, strict in (("news", True), ("music", False)):  # phase 14
        audios = [AudioData(pcm=small_clips[i], sample_rate=SR,
                            metadata=AudioMetadata(extra={"content_type": label})) for i in range(2)]
        g = FingerprintGenerator(gen_cfg, strict_reference_routing=strict)
        on_card = g.generate_fingerprints_batch(audios, pcm_matrix=small_clips.to(dev))
        on_cpu = g.generate_fingerprints_batch(audios, pcm_matrix=small_clips)
        for i, (fc, fh) in enumerate(zip(on_card, on_cpu)):
            near = near_zero_for(small_clips[i], label == "music")
            require(parity.check_extracted(features_to_numpy(fc.features), features_to_numpy(fh.features),
                                           SR, WINDOW, near_zero=near, n_samples=SR),
                    f"generator {label} (strict={strict}) [2, {SR}] row {i}, card vs CPU")
    mus_card = {k: np32(v) for k, v in batched_music_extractor_features(small_clips.to(dev)).items()}
    mus_cpu = {k: v.numpy() for k, v in batched_music_extractor_features(small_clips).items()}
    clips16 = parity.harmonic_clips(2, 16000, SEED + 8, 16000)
    mus16_card = {k: np32(v) for k, v in batched_music_extractor_features(clips16.to(dev), 16000).items()}
    mus16_cpu = {k: v.numpy() for k, v in batched_music_extractor_features(clips16, 16000).items()}
    require(parity.check_extracted(mus16_card, mus16_cpu, 16000, WINDOW,
                                   near_zero=near_zero_for(clips16, True), n_samples=16000,
                                   chord_margin=chord_margin(mus16_cpu["chroma"])),
            "music program [2, 16000] at 16 kHz, card vs CPU (ZCR exact)")
    log(f"[music program at 16 kHz] ZCR bit-equal on "
        f"{int((mus16_card['zcr'] == mus16_cpu['zcr']).sum())} of {mus16_cpu['zcr'].size} frames")
    require(parity.check_extracted(mus_card, mus_cpu, SR, WINDOW, near_zero=near_zero_for(small_clips, True),
                                   n_samples=SR, chord_margin=chord_margin(mus_cpu["chroma"])),
            f"music program [2, {SR}], card vs CPU")

    classes = run_extractor_classes(card, dev, clips, gen_cfg)  # phases 30-32

    for name, kern, plain, x, kw in (                         # phase 15
        ("K2amp", k2, k2_plain, full_sp, dict(with_period_amp=True)),
        ("K4", k4, k4_plain, real, {}),
    ):
        args = VQ_ARGS if name == "K2amp" else (8,)
        times[name] = in_turns(lambda: kern(x, *args, **kw), lambda: plain(x, *args, **kw), 10)
        log(f"{name} at {tuple(x.shape)}: kernel {times[name][0]:.4f} ms, "
            f"plain {times[name][1]:.3f} ms [{card}]")
        torch.cuda.empty_cache()
    del full_sp
    # K4's kernel takes less time than its wrapper's host work: its entry
    # keeps the events' time as `ms`, as every kernel's, and the kernel's
    # own device time (torch.profiler) as `device_ms`
    k4_device_ms = parity.device_ms(lambda: k4(real, 8), "thin_kernel", 50)
    log(f"K4 at {tuple(real.shape)}: {k4_device_ms:.4f} ms on the device alone (torch.profiler), "
        f"{times['K4'][0]:.4f} ms per call by CUDA events [{card}]")

    profile_step("generator news", gen_step)                  # phase 16
    profile_step("music program", music_step)
    log(f"step times: main path {ms:.2f}, generator news {gen_ms:.2f}, "
        f"music program {music_ms:.2f} ms [{card}]")
    del clips, full
    torch.cuda.empty_cache()

    align = run_alignment(card, dev)                # phases 17-22

    with tempfile.TemporaryDirectory(prefix="sonido_ingest_") as tmp:   # phases 33-34
        corpus, ingest = run_ingest(card, Path(tmp))
        latency = run_cdn_latency(card, dev, Path(tmp), corpus, info.seconds)
    accuracy = run_accuracy(card, dev)                                  # phase 35
    stream = run_stream_phase(card, dev)                                # phase 36
    music = run_music_analysis(card, dev)                               # phase 37
    surface = run_op_surface(card, dev)                                 # phase 38
    mesh = run_mesh(card, dev)                                          # phase 39
    warm = run_warmup(card)                                             # phase 40

    for mod in ("jax", "sonido_sonar_tpu"):
        if mod in sys.modules:
            raise AssertionError(f"{mod} was imported")
    bounds["fill"], bounds["backtrack"] = align["bounds"]["fill"], align["bounds"]["backtrack"]
    bounds["K9"], bounds["K3"] = fslice["K9_bound"], fslice["K3_bound"]
    kernels = [
        {"name": "K1 stft_magnitude_aux", "route": "cuda",
         "source": "sonido_sonar_tpu_torch/csrc/stft.cu",
         "replaces": "sonido_sonar_tpu/ops/pallas_stft.py:145",
         "launches": launches["K1"], "max_abs_err": errs["K1", "full"]["magnitude"],
         "ms": times["K1"][0], "plain_ms": times["K1"][1], "key": "K1",
         "library_ms": fslice["K1_library_ms"]},
        {"name": "K2 yin_pitch", "route": "cuda",
         "source": "sonido_sonar_tpu_torch/csrc/yin.cu",
         "replaces": "sonido_sonar_tpu/ops/pallas_yin.py:238",
         "launches": launches["K2"], "max_abs_err": errs["K2", "full"]["pitch_max_abs"],
         "ms": times["K2"][0], "plain_ms": times["K2"][1], "key": "K2"},
        {"name": "K2 yin_pitch with_period_amp", "route": "cuda",
         "source": "sonido_sonar_tpu_torch/csrc/yin.cu",
         "replaces": "sonido_sonar_tpu/ops/pallas_yin.py:356",
         "launches": gen_launches["K2amp"], "max_abs_err": errs["K2amp", "full"]["amp_max_abs"],
         "ms": times["K2amp"][0], "plain_ms": times["K2amp"][1], "key": "K2amp"},
        {"name": "K3 yin_difference", "route": "cuda",
         "source": "sonido_sonar_tpu_torch/csrc/yin.cu",
         "replaces": "sonido_sonar_tpu/ops/pallas_yin.py:162",
         "launches": fslice["K3_launches"], "max_abs_err": fslice["K3_err"],
         "ms": fslice["K3_times"][0], "plain_ms": fslice["K3_times"][1], "key": "K3"},
        {"name": "K4 thin_onsets", "route": "cuda",
         "source": "sonido_sonar_tpu_torch/csrc/onsets.cu",
         "replaces": "sonido_sonar_tpu/ops/pallas_onsets.py:60",
         "launches": music_launches["K4"], "max_abs_err": 0.0,
         "ms": times["K4"][0], "plain_ms": times["K4"][1], "key": "K4",
         "device_ms": k4_device_ms},
        {"name": "K5/K6/K7 dtw_fill_banded", "route": "cuda",
         "source": "sonido_sonar_tpu_torch/csrc/dtw.cu",
         "replaces": "sonido_sonar_tpu/ops/stats/pallas_dtw.py:297, :439, :173",
         "launches": align["launches"]["fill"], "max_abs_err": align["fill_err"],
         "ms": align["times"]["fill"][0], "plain_ms": align["times"]["fill"][1], "key": "fill",
         "ms_b32": align["times"]["fill_b32"]},
        {"name": "K8 dtw_backtrack_banded", "route": "cuda",
         "source": "sonido_sonar_tpu_torch/csrc/dtw.cu",
         "replaces": "sonido_sonar_tpu/ops/stats/pallas_backtrack.py:150",
         "launches": align["launches"]["backtrack"], "max_abs_err": align["walk_err"],
         "ms": align["times"]["backtrack"][0], "plain_ms": align["times"]["backtrack"][1],
         "key": "backtrack", "ms_b32": align["times"]["backtrack_b32"],
         "ms_l2_flushed": align["times"]["backtrack_b2_cold"],
         "ms_b32_l2_flushed": align["times"]["backtrack_b32_cold"]},
        {"name": "K9 contrast_band_means", "route": "cuda",
         "source": "sonido_sonar_tpu_torch/csrc/contrast.cu",
         "replaces": "sonido_sonar_tpu/ops/pallas_contrast.py:140",
         "launches": launches["K9"], "max_abs_err": fslice["K9_err"],
         "contrast_gap_db": contrast_gap_db,
         "ms": fslice["K9_times"][0], "plain_ms": fslice["K9_times"][1], "key": "K9"},
        {"name": "K10 stft_features", "route": "cuda",
         "source": "sonido_sonar_tpu_torch/csrc/stft.cu",
         "replaces": "sonido_sonar_tpu/ops/pallas_stft.py:334",
         "launches": fslice["feat_launches"]["K10"], "max_abs_err": fslice["K10_err"],
         "ms": fslice["K10_times"][0], "plain_ms": fslice["K10_times"][1], "key": "K10"},
    ]
    for k in kernels:
        k["bound_ms"], k["bound_by"] = bounds[k.pop("key")]
        k.setdefault("library_ms", None)
        log(f"{k['name']}: {k['ms']:.4f} ms, bound {k['bound_ms']:.4f} ms by {k['bound_by']} "
            f"({100 * k['bound_ms'] / k['ms']:.1f} % of it), plain {k['plain_ms']:.3f} ms, "
            f"launches {k['launches']} [{card}]")
    log(f"main path step: default {fslice['step_ms_default']:.2f} ms, feature epilogue "
        f"{fslice['step_ms_feat']:.2f} ms [{card}]")
    print(json.dumps({"comparator": comparator}), flush=True)
    print(json.dumps({"extractor_classes": classes}), flush=True)
    for key, value in (("ingest", ingest), ("cdn_latency", latency), ("accuracy", accuracy),
                       ("stream", stream), ("music_analysis", music), ("op_surface", surface),
                       ("mesh", mesh), ("warmup", warm)):
        print(json.dumps({key: value}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
