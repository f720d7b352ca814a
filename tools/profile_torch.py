#!/usr/bin/env python3
"""Where the PyTorch port's main path spends its device time.

    python3 tools/profile_torch.py [--batch 128] [--seconds 30] [--steps 3]

Runs `batched_fingerprint_features` (window 1024, hop 256, 44.1 kHz) on
CUDA device 0 under torch.profiler after one warm-up step, then prints
the card's name and power limit, the wall time per step, the device's
busy share (sum of kernel times over wall time) and the 40 CUDA kernels
with the most device time. With SONIDO_ENABLE_FEAT_EPILOGUE=1 in the
environment the step is the feature-epilogue configuration's.
Needs a CUDA card; inputs come from utils/parity.synth_pcm with seed 0.

    python3 tools/profile_torch.py --ablate-stft [NAME ...]

times K1 and K10 (B=128 x 30 s, 44.1 kHz, window 1024, hop 256) built
from edited copies of csrc/stft.cu instead, one STFT_ABLATIONS entry
each, all in one call on one card: each copy of the package builds into
its own _build/ in a temporary directory and runs in its own process.
It prints K1, K10 and their difference (the feature epilogue's time),
registers and spills, K1 held to its plain version and K10's lanes to
the plain epilogue on the kernel's own magnitudes. A variant that drops a
part gives wrong outputs (its parity line says so) and measures only
that part's share of the kernel's time; the others show what a design
choice is worth.

    python3 tools/profile_torch.py --ablate-yin [NAME ...]

does the same for csrc/yin.cu (YIN_ABLATIONS): K2 at 1024/512 held to its
plain version, then K2, K2 with the period amplitude (1024/256) and K3
(1024/512) timed at B=128 x 30 s.

    python3 tools/profile_torch.py --ablate-dtw [NAME ...]

does the same for csrc/dtw.cu (DTW_ABLATIONS): the fill held to its plain
version at [2, 1500, 1] band 700, then the distance pre-pass timed at the
fleet's sub-batch [32, 10332, 1] band 5167 and the row recurrence at
[2, 10332, 1] band 5167 (shared rows) and [2, 3000 x 2900, 1] band 20671
(rows in the band), with us per row.

    python3 tools/profile_torch.py --ablate-walk [NAME ...]

does the same for the backtrack in csrc/dtw.cu (WALK_ABLATIONS, among
them the ring's rows R and columns C): K8 held to its plain version and
timed, with us per step and each pair's misses, on the fleet's energies
[2, 10332, 1] band 5167 (a related pair delayed 2.9 s, an unrelated
one), a prescribed-path band of that geometry (3,000-step up and left
runs, utils/parity.prescribed_path_band) and K6's [8, 2048, 12] band 64.

    python3 tools/profile_torch.py --ablate-onsets [NAME ...]

does the same for csrc/onsets.cu (ONSETS_ABLATIONS): K4 held bit for bit
to its plain version and its device time (torch.profiler) on the music
step's flux candidates and on random ones at [128, 5163] (densities 0.3
and 0.002), min_frames 8.

    python3 tools/profile_torch.py --ablate-contrast [NAME ...]

does the same for csrc/contrast.cu (CONTRAST_ABLATIONS): K9 held to its
plain version (utils/parity.check_band_means) and its device time at the
main path's magnitudes [128, 5164, 513], with the lane plan's registers
and spills.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


# name -> regex edits of csrc/stft.cu (each must match exactly once)
STFT_ABLATIONS = {
    "shipped": [],
    "no_register_bound": [(r"__launch_bounds__\(kThreads, min_blocks\(kLog2N\)\)",
                           "__launch_bounds__(kThreads)")],
    "ieee_sqrt": [(r"sqrt_approx\(re \* re \+ im \* im\)", "sqrtf(re * re + im * im)")],
    "tile_12_frames": [(r"kTileMax = 16;", "kTileMax = 12;")],
    "drop_magnitude_stores": [(r"\n        out\[k\] = mg\[i\];", "")],
    "drop_passes_after_0": [(r"\n    fft_passes_from<kLog2N, 1>\(buf, twiddle, lane\);", "")],
    "drop_rolloff_search": [(r"__ballot_sync\(kFull, in_chunk && base \+ v >= thr\)", "0u")],
    # K10's feature epilogue, part by part (the weighted sums' segment
    # walk; the descriptor sums on the split's pass and the bandwidth's
    # pass; the chroma total and division), and design variants
    "drop_weighted_sums": [(r"(?s)\n  if \(plan\.x > 0\) \{\n    const int2\* col.*?\n    slots\[lane \+ cur\] = acc;\n  \}", "")],
    "drop_descriptor_passes": [(r"\n        if constexpr \(kFeatures\) desc\.add\([^\n]*\);", ""),
                               (r"(?s)\n  for \(int k = lane; k < f_bins; k \+= 32\) \{\n    const float dk.*?\n  \}", "")],
    "drop_descriptor_sums": [(r"\n        if constexpr \(kFeatures\) desc\.add\([^\n]*\);", "")],
    "drop_bandwidth_pass": [(r"(?s)\n  for \(int k = lane; k < f_bins; k \+= 32\) \{\n    const float dk.*?\n  \}", "")],
    "drop_descriptor_finish": [(r"  if \(lane == 0\) \{  // finish the five[^\n]*", "  if (false) {")],
    "fast_finish": [(r"return a / b;", "return __fdividef(a, b);"),
                    (r"return sqrtf\(x\);", "return sqrt_approx(x);"),
                    (r"return exp2f\(x\);",
                     "float y;\n  asm(\"ex2.approx.f32 %0, %1;\" : \"=f\"(y) : \"f\"(x));\n  return y;")],
    "finish_in_every_lane": [(r"  if \(lane == 0\) \{  // finish the five[^\n]*", "  {")]
    + [(r"\n    out\[kSums%s\] = " % re.escape(k), "\n    if (lane == 0) out[kSums%s] = " % k)
       for k in ("", " + 1", " + 2", " + 3", " + 4")],
    "chroma_reciprocal": [(r"  auto norm = \[&\]\(float e\) \{ return total > kEps \? e / fmaxf\(total, kEps\) : e; \};",
                           "  const float inv = 1.f / fmaxf(total, kEps);\n"
                           "  auto norm = [&](float e) { return total > kEps ? e * inv : e; };")],
    "drop_chroma_normalize": [(r"warp_sum\(\(lane >= kMel \? v0 : 0\.f\) \+ v1\)", "0.f")],
    "ieee_log": [(r"return __log2f\(x\);", "return log2f(x);")],
    # kWalkStep must divide ops/hopper_stft.WALK_STEP (the table's padding)
    "walk_step_1": [(r"kWalkStep = 4;", "kWalkStep = 1;")],
    "walk_step_2": [(r"kWalkStep = 4;", "kWalkStep = 2;")],
}

# name -> regex edits of csrc/yin.cu (each must match exactly once)
YIN_ABLATIONS = {
    "shipped": [],
    "no_register_bound": [(r"__launch_bounds__\(kThreads, min_blocks\(kLog2N\)\)",
                           "__launch_bounds__(kThreads)")],
    "sig_cap_8192": [(r"kSigCap = 5120;", "kSigCap = 8192;")],
    "drop_forward_passes": [(r"\n    fft_passes_from<kLog2N, 1>\(buf_a, twiddle, lane\);", ""),
                            (r"\n    fft_passes_from<kLog2N, 1>\(buf_b, twiddle, lane\);", "")],
    "drop_cross_spectrum": [(r"\n    cross_spectrum<N>\(buf_a, buf_b, twiddle, lane\);", "")],
    "drop_inverse": [(r"\n    fft_passes_from<kLog2N, 0>\(buf_b, twiddle, lane\);", "")],
    "tile_4_5_blocks": [(r"kTileMax = 16;", "kTileMax = 4;"),
                        (r"log2n == 9 \? 4 : 2", "log2n == 9 ? 5 : 2")],
    "fast_cmndf_division": [(r"d\[t\] \* \(float\)u / fmaxf\(base \+ loc\[t\], kEps\)",
                             "__fdividef(d[t] * (float)u, fmaxf(base + loc[t], kEps))")],
    "drop_pre_emphasis": [(r"if \(pre_emph != 0.f\) \{", "if (false) {")],
    "drop_candidate_search": [(r"first = __reduce_min_sync\(kFull, first\);", "first = H;")],
}

# name -> regex edits of csrc/dtw.cu (each must match exactly once)
DTW_ABLATIONS = {
    "shipped": [],
    "threads_512": [(r"kSharedThreads = 256;", "kSharedThreads = 512;"),
                    (r"kMaxRun = 77;", "kMaxRun = 39;")],
    "threads_1024": [(r"kSharedThreads = 256;", "kSharedThreads = 1024;"),
                     (r"kMaxRun = 77;", "kMaxRun = 19;")],
    "global_threads_512": [(r"kGlobalThreads = 1024;", "kGlobalThreads = 512;")],
    "drop_prefetch": [(r"\n      row_to_shared\(next_buf, crow \+ w, w, bar, tid, nthreads\);", ""),
                      (r"\n    if \(i < n\) wait_phase\(bar, i & 1\);", "")],
    "drop_copy_out": [(r"\n    shared_to_row\(crow, cur_buf, w, tid, nthreads\);", "")],
    "drop_warp_totals": [(r"combine\(warps_before\(tot_c, tot_a, lane, warp\), "
                          r"lane_exclusive\(inc, lane\)\)", "lane_exclusive(inc, lane)")],
}

_DTW_ABLATION_RUN = r"""
import numpy as np, torch
from sonido_sonar_tpu_torch.ops.stats import hopper_dtw as H
from sonido_sonar_tpu_torch.utils import parity
rng = np.random.default_rng(5)
def rand(*s):
    return torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).cuda()
def ms(fn, iters=3):
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters
q = rand(2, 1500, 1).abs()
r = torch.roll(q, 7, 1).contiguous()
_, failures = parity.check_fill(H.fill_banded_hopper(q, r, 700, 1500, 1500).cpu().numpy(),
                                H.fill_banded_plain(q, r, 700, 1500, 1500).cpu().numpy())
qe = rand(32, 10332, 1).abs()
re_ = torch.roll(qe, 7, 1).contiguous()
pre = ms(lambda: H.local_distances_hopper(qe, re_, 5167, 10332, 10332))
loc = H.local_distances_hopper(qe[:2].contiguous(), re_[:2].contiguous(), 5167, 10332, 10332)
rows = ms(lambda: H.fill_rows_hopper(loc, 5167, 10332, 10332))
qw, rw = rand(2, 3000, 1), rand(2, 2900, 1)
locw = H.local_distances_hopper(qw, rw, 20671, 3000, 2900)
wide = ms(lambda: H.fill_rows_hopper(locw, 20671, 3000, 2900))
print("pre-pass [32, 10332, 1] band 5167 %.3f ms; recurrence [2, 10332, 1] band 5167 %.3f ms "
      "(%.3f us per row), [2, 3000 x 2900, 1] band 20671 %.3f ms (%.3f us per row); parity %s"
      % (pre, rows, 1e3 * rows / 10332, wide, 1e3 * wide / 3000,
         "ok" if not failures else "FAIL (" + failures[0] + ")"))
"""

# name -> regex edits of csrc/dtw.cu for the backtrack K8 (each must
# match exactly once)
WALK_ABLATIONS = {
    "shipped": [],
    "drop_output_stores": [(r"\n    qb\[t\] = i - 1;\n    rbp\[t\] = j - 1;\n    csb\[t\] = c;", "")],
    "drop_miss_path": [(r"\n        if \(!\(k >= v\.up\.lo && [^\n]*\) break;", "")],
    "drop_path_cost": [(r"\n    float c = __fsub_rn\(c_ij, dv\);\n    if \(!\(fabsf\(c\) < 1e30f\)\) "
                        r"c = 0\.0f;", "\n    const float c = 0.0f;")],
    # diagnostics: each pair's misses + the walker's refreshes of the
    # published row (refresh_count) or + its cycles in them / 100
    "refresh_count": [(r"\n        seen = wait_front\(front, i - 1\);",
                       "\n        seen = wait_front(front, i - 1);\n        ++misses;")],
    "refresh_cycles": [(r"\n        seen = wait_front\(front, i - 1\);",
                        "\n        const long long t_w = clock64();\n        seen = wait_front(front, i - 1);"
                        "\n        misses += static_cast<int>((clock64() - t_w) / 100);")],
    "ring_rows_32": [(r"kRingRows = 64;", "kRingRows = 32;")],
    "ring_rows_128": [(r"kRingRows = 64;", "kRingRows = 128;")],
    "ring_cols_128": [(r"kRingCols = 256;", "kRingCols = 128;")],
    "ring_cols_512": [(r"kRingCols = 256;", "kRingCols = 512;")],
}

# the step with only its comparisons and moves left (timing only)
WALK_ABLATIONS["minimal_step"] = [e for k in ("drop_miss_path", "drop_path_cost",
                                              "drop_output_stores")
                                  for e in WALK_ABLATIONS[k]]

_WALK_ABLATION_RUN = r"""
import re, numpy as np, torch
from sonido_sonar_tpu_torch import _build
from sonido_sonar_tpu_torch.ops.stats import hopper_backtrack as HB, hopper_dtw as HD
from sonido_sonar_tpu_torch.ops.temporal import short_time_energy
from sonido_sonar_tpu_torch.utils import parity
log = _build.build()[1].compiler_log
regs = re.findall(r"backtrack_banded_kernel[^']*' for.*?Used (\d+) registers", log, re.S)
def ms(fn, iters=3):
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters
def walk(cost, band, n, m):
    (got, misses) = HB.backtrack_banded_misses(cost, band, n, m)
    want = HB.backtrack_banded_plain(cost, band, n, m)
    fail = parity.check_backtrack([t.cpu().numpy() for t in got], [t.cpu().numpy() for t in want])[1]
    t = ms(lambda: HB.backtrack_banded_hopper(cost, band, n, m))
    steps = int(got[3].max())
    return t, 1e3 * t / steps, misses.tolist(), fail
src, cdn = parity.alignment_streams(2, 60, 44100, [int(2.9 * 44100), 0], 11, unrelated=(1,),
                                    device="cuda")
es = short_time_energy(src, 1024, 256)[..., None].contiguous()
ec = short_time_energy(cdn, 1024, 256)[..., None].contiguous()
n = es.shape[1]
fleet = walk(HD.fill_banded_hopper(es, ec, 5167, n, n), 5167, n, n)
runs = [("D", 100), ("U", 3000), ("D", 200), ("L", 3000), ("D", n - 3300)]
pb = parity.prescribed_path_band(runs, 5167, 7, device="cuda")[0][None].contiguous()
pres = walk(pb, 5167, n, n)
del pb
q6 = torch.from_numpy(np.random.default_rng(3).standard_normal((8, 2048, 12), dtype=np.float32)).cuda()
k6 = walk(HD.fill_banded_hopper(q6, torch.roll(q6, 5, 1).contiguous(), 64, 2048, 2048), 64, 2048, 2048)
fails = fleet[3] + pres[3] + k6[3]
print("fleet [2, %d, 1] band 5167 %.3f ms (%.4f us per step, misses %s); prescribed band %.3f ms "
      "(%.4f us per step, misses %s); K6 %.3f ms (%.4f us per step); %s registers; parity %s"
      % (n, fleet[0], fleet[1], fleet[2], pres[0], pres[1], pres[2], k6[0], k6[1],
         "/".join(regs), "ok" if not fails else "FAIL (" + fails[0] + ")"))
"""

_YIN_ABLATION_RUN = r"""
import re, torch
from sonido_sonar_tpu_torch import _build
from sonido_sonar_tpu_torch.ops import hopper_yin as Y
from sonido_sonar_tpu_torch.ops.filters import pre_emphasis_for_content
from sonido_sonar_tpu_torch.utils import parity
log = _build.build()[1].compiler_log
found = re.findall(r"yin_kernelILi9ELb([01])E[^']*' for.*?(\d+) bytes spill stores.*?"
                   r"Used (\d+) registers", log, re.S)
x = parity.synth_pcm(128, 30 * 44100, 1, 44100, "cuda")
sp = pre_emphasis_for_content(x, "speech").contiguous()
args = (1024, 512, 44100, 80.0, 1000.0, 0.15, 0.97)
p, c, _ = Y.yin_pitch_hopper(x, *args)
pp, pc, _ = Y.yin_pitch_plain(x, *args)
_, failures = parity.check_pitch(p.cpu().numpy(), c.cpu().numpy(), pp.cpu().numpy(), pc.cpu().numpy())
def ms(fn, iters=10):
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters
k2 = [ms(lambda: Y.yin_pitch_hopper(x, *args)) for _ in range(2)]
amp = [ms(lambda: Y.yin_pitch_hopper(sp, 1024, 256, 44100, 50.0, 500.0, 0.15, 0.0, True))
       for _ in range(2)]
k3 = [ms(lambda: Y.yin_difference_hopper(x, 1024, 512)) for _ in range(2)]
print("K2 %.3f ms, K2 amp %.3f ms, K3 %.3f ms; " % (sum(k2) / 2, sum(amp) / 2, sum(k3) / 2)
      + ", ".join("%s %s registers, %s B spilled" % ("K3" if f == "1" else "K2", r, sp_)
                  for f, sp_, r in found)
      + "; K2 parity " + ("ok" if not failures else "FAIL (" + failures[0] + ")"))
"""

_ABLATION_RUN = r"""
import re, torch
from sonido_sonar_tpu_torch import _build
from sonido_sonar_tpu_torch.ops import hopper_stft as H
from sonido_sonar_tpu_torch.utils import parity
log = _build.build()[1].compiler_log
found = re.findall(r"stft_aux_kernelILi9ELb([01])E[^']*' for.*?(\d+) bytes spill stores.*?"
                   r"Used (\d+) registers", log, re.S)
x = parity.synth_pcm(128, 30 * 44100, 1, 44100, "cuda")
mag, aux = H.stft_magnitude_hopper(x, 1024, 256, pre_emph=0.97)
pmag, paux = H.stft_magnitude_plain(x, 1024, 256, pre_emph=0.97)
host = lambda d: {k: v.cpu().numpy() for k, v in d.items()}
_, failures = parity.check_stft_aux(mag.cpu().numpy(), host(aux), pmag.cpu().numpy(), host(paux),
                                    parity.near_zero_frames(x.cpu().numpy(), 1024, 256, 0.97))
del mag, aux, pmag, paux
mag, _, feat = H.stft_magnitude_hopper(x, 1024, 256, pre_emph=0.97, with_features=True,
                                       sample_rate=44100)
_, feat_failures = parity.check_feat(feat.cpu().numpy(),
                                     H.frame_features(mag, 44100, 1024).cpu().numpy(),
                                     same_magnitudes=True)
del mag, feat
def ms(fn, iters=10):
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters
kw = dict(pre_emph=0.97, with_features=True, sample_rate=44100)
k1 = [ms(lambda: H.stft_magnitude_hopper(x, 1024, 256, pre_emph=0.97)) for _ in range(2)]
k10 = [ms(lambda: H.stft_magnitude_hopper(x, 1024, 256, **kw)) for _ in range(2)]
print("K1 %.3f ms, K10 %.3f ms, epilogue (K10 - K1) %.3f ms; "
      % (sum(k1) / 2, sum(k10) / 2, (sum(k10) - sum(k1)) / 2)
      + ", ".join("%s %s registers, %s B spilled" % ("K10" if f == "1" else "K1", r, sp)
                  for f, sp, r in found)
      + "; K1 parity " + ("ok" if not failures else "FAIL (" + failures[0] + ")")
      + "; K10 parity " + ("ok" if not feat_failures else "FAIL (" + feat_failures[0] + ")"))
"""


# name -> regex edits of csrc/onsets.cu (K4); "kernel" is the source as it is
ONSETS_ABLATIONS = {
    "kernel": [],
    # the stage, ballots and write alone: the walk's share is the rest
    "no_walk": [(r"    if \(warp == 0\) \{\n      const unsigned cand", "    if (false) {\n      const unsigned cand")],
    # each step's lowest bit by __ffs (bit reverse, find leading one) on the chain
    "ffs_per_step": [(r"below = m \^ \(m - 1ull\);", "below = (2ull << (__ffsll(m) - 1)) - 1ull;")],
    # no mask carried into the next word: each word left by a seek from the kept frame
    "seek_every_word": [(r"if \(min_frames <= 64\) \{", "if (false) {")],
    # one 16-byte load per thread in flight (tiles of 4,064 frames: two at T = 5,163)
    "one_load_in_flight": [(r"kChunksPerThread = 4;", "kChunksPerThread = 1;")],
}

# name -> regex edits of csrc/contrast.cu (K9's lane plan); "kernel" as it is
CONTRAST_ABLATIONS = {
    "kernel": [],
    # no early end: all 31 rounds for every frame
    "all_31_rounds": [(r"    if \(!__any_sync\(kFull, me\.x >= 0 && \(gt - at > 1u \|\| gb - ab > 1u\)\)\) break;\n", "")],
    # the counts by subtract and shift (bit 31 of t - 1 - x), two partial
    # sums a selection: no predicates, more registers (a variant, not adopted)
    "subtract_shift_counts": [(
        r"    unsigned nt = 0u, nbt = 0u;\n#pragma unroll\n    for \(int s = 0; s < K; \+\+s\) \{\n"
        r"      nt \+= key\[s\] >= ct;\n      nbt \+= key\[s\] >= cb;\n    \}\n"
        r"    unsigned c = nt \| \(nbt << 16\);",
        "    unsigned nt0 = 0u, nt1 = 0u, nb0 = 0u, nb1 = 0u;\n#pragma unroll\n"
        "    for (int s = 0; s < K; s += 2) {\n"
        "      nt0 += (ct - 1u - key[s]) >> 31;\n      nb0 += (cb - 1u - key[s]) >> 31;\n"
        "      nt1 += (ct - 1u - key[s + 1]) >> 31;\n      nb1 += (cb - 1u - key[s + 1]) >> 31;\n"
        "    }\n    unsigned c = (nt0 + nt1) | ((nb0 + nb1) << 16);")],
    # loads and the last pass only (no rounds: wrong means), the rounds' share is the rest
    "no_rounds": [(r"  while \(bit > 0\) \{\n    const unsigned half", "  while (bit > 99) {\n    const unsigned half")],
}

_ONSETS_ABLATION_RUN = r"""
import re, numpy as np, torch
from sonido_sonar_tpu_torch import _build
from sonido_sonar_tpu_torch.ops import hopper_onsets as H
from sonido_sonar_tpu_torch.ops import temporal as T
from sonido_sonar_tpu_torch.ops.hopper_stft import stft_magnitude_hopper
from sonido_sonar_tpu_torch.ops.stft import spectral_flux
from sonido_sonar_tpu_torch.utils import parity
log = _build.build()[1].compiler_log
regs = re.findall(r"thin_kernel[^']*' for.*?(\d+) bytes spill stores.*?Used (\d+) registers", log, re.S)
x = parity.synth_pcm(128, 30 * 44100, 1, 44100, "cuda")
flux = T.flux_onset_candidates(spectral_flux(stft_magnitude_hopper(x, 1024, 256)[0]), 0.3).contiguous()
rand = torch.from_numpy(np.random.default_rng(1).random((128, 5163)) < 0.3).cuda()
sparse = torch.from_numpy(np.random.default_rng(2).random((128, 5163)) < 0.002).cuda()
res = []
for name, cand in (("flux", flux), ("rand30", rand), ("rand002", sparse)):
    ok = torch.equal(H.thin_onsets_hopper(cand, 8), H.thin_onsets_plain(cand, 8))
    res.append("%s %.4f ms on the device (%d kept of %d), %s" % (
        name, parity.device_ms(lambda: H.thin_onsets_hopper(cand, 8), "thin_kernel", 50),
        int(H.thin_onsets_plain(cand, 8).sum()), int(cand.sum()),
        "bit-equal to plain" if ok else "DIFFERS from plain"))
print("; ".join(res) + "; " + ", ".join("%s registers, %s B spilled" % (r, sp) for sp, r in regs))
"""


_CONTRAST_ABLATION_RUN = r"""
import re, torch
from sonido_sonar_tpu_torch import _build
from sonido_sonar_tpu_torch.ops import hopper_contrast as C
from sonido_sonar_tpu_torch.ops.hopper_stft import stft_magnitude_hopper
from sonido_sonar_tpu_torch.ops.spectral import contrast_band_edges
from sonido_sonar_tpu_torch.utils import parity
log = _build.build()[1].compiler_log
regs = re.findall(r"band_means_lanes_kernelILi(\d+)E[^']*' for.*?(\d+) bytes spill stores.*?Used (\d+) registers", log, re.S)
mag = stft_magnitude_hopper(parity.synth_pcm(128, 30 * 44100, 1, 44100, "cuda"), 1024, 256, pre_emph=0.97)[0]
edges = contrast_band_edges(6, 513, 44100)
got = C.band_select_means_hopper(mag, edges)
ref = C.band_select_means_plain(mag, edges)
_, failures = parity.check_band_means(*(t.cpu().numpy() for t in (*got, *ref)))
t = [parity.device_ms(lambda: C.band_select_means_hopper(mag, edges), "band_means", 10)
     for _ in range(2)]
print("K9 %.4f / %.4f ms on the device at %s; parity %s; %s" % (
    t[0], t[1], tuple(mag.shape), "ok" if not failures else "FAIL (" + failures[0] + ")",
    ", ".join("K=%s: %s registers, %s B spilled" % (k, r, sp) for k, sp, r in regs if k in ("18", "20", "40"))))
"""


def ablate(source: str, table: dict, run: str, names, card: str) -> int:
    """Build the package from each named variant of csrc/<source> (its
    regex edits in `table`) and print what `run` measures there."""
    print(f"card: {card}")
    for name in names or list(table):
        with tempfile.TemporaryDirectory(prefix=f"{Path(source).stem}_{name}_") as tmp:
            pkg = Path(tmp) / "sonido_sonar_tpu_torch"
            shutil.copytree(ROOT / "sonido_sonar_tpu_torch", pkg,
                            ignore=shutil.ignore_patterns("_build", "__pycache__"))
            src = pkg / "csrc" / source
            text = src.read_text()
            for pattern, repl in table[name]:
                text, n = re.subn(pattern, repl, text)
                if n != 1:
                    raise SystemExit(f"profile_torch: {name}: {pattern!r} matched {n} times")
            src.write_text(text)
            res = subprocess.run([sys.executable, "-c", run], cwd=tmp,
                                 env={**os.environ, "PYTHONPATH": tmp},
                                 capture_output=True, text=True, timeout=600)
            out = res.stdout.strip() if res.returncode == 0 else "failed:\n" + res.stderr[-2000:]
            print(f"{name}: {out}", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seconds", type=int, default=30)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--ablate-stft", nargs="*", metavar="NAME", choices=list(STFT_ABLATIONS),
                    help="time K1/K10 from edited copies of csrc/stft.cu (default: all)")
    ap.add_argument("--ablate-yin", nargs="*", metavar="NAME", choices=list(YIN_ABLATIONS),
                    help="time K2/K3 from edited copies of csrc/yin.cu (default: all)")
    ap.add_argument("--ablate-dtw", nargs="*", metavar="NAME", choices=list(DTW_ABLATIONS),
                    help="time the DTW fill's kernels from edited copies of csrc/dtw.cu "
                         "(default: all)")
    ap.add_argument("--ablate-walk", nargs="*", metavar="NAME", choices=list(WALK_ABLATIONS),
                    help="time the DTW backtrack from edited copies of csrc/dtw.cu "
                         "(default: all)")
    ap.add_argument("--ablate-onsets", nargs="*", metavar="NAME", choices=list(ONSETS_ABLATIONS),
                    help="time K4 from edited copies of csrc/onsets.cu (default: all)")
    ap.add_argument("--ablate-contrast", nargs="*", metavar="NAME", choices=list(CONTRAST_ABLATIONS),
                    help="time K9 from edited copies of csrc/contrast.cu (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sonido_sonar_tpu_torch.parallel.pipeline import (
        batched_fingerprint_features,
        feat_epilogue_enabled,
    )
    from sonido_sonar_tpu_torch.utils.parity import synth_pcm

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    if args.ablate_stft is not None:
        return ablate("stft.cu", STFT_ABLATIONS, _ABLATION_RUN, args.ablate_stft, card)
    if args.ablate_yin is not None:
        return ablate("yin.cu", YIN_ABLATIONS, _YIN_ABLATION_RUN, args.ablate_yin, card)
    if args.ablate_dtw is not None:
        return ablate("dtw.cu", DTW_ABLATIONS, _DTW_ABLATION_RUN, args.ablate_dtw, card)
    if args.ablate_walk is not None:
        return ablate("dtw.cu", WALK_ABLATIONS, _WALK_ABLATION_RUN, args.ablate_walk, card)
    if args.ablate_onsets is not None:
        return ablate("onsets.cu", ONSETS_ABLATIONS, _ONSETS_ABLATION_RUN, args.ablate_onsets, card)
    if args.ablate_contrast is not None:
        return ablate("contrast.cu", CONTRAST_ABLATIONS, _CONTRAST_ABLATION_RUN, args.ablate_contrast,
                      card)
    sr = 44100
    x = synth_pcm(args.batch, args.seconds * sr, 0, sr, "cuda")
    batched_fingerprint_features(x)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            batched_fingerprint_features(x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps
    events = prof.key_averages()
    # kernels only: an aten op's self device time is its kernels' again
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels) / args.steps
    print(f"card: {card}")
    print(f"configuration: {'feature epilogue' if feat_epilogue_enabled() else 'default'}")
    print(f"B={args.batch} x {args.seconds} s: {1e3 * wall:.2f} ms/step wall (profiled), "
          f"device busy {1e-3 * device_us:.2f} ms/step = {100 * device_us * 1e-6 / wall:.1f} %")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:40]:
        if e.self_device_time_total > 0:
            print(f"{e.self_device_time_total / args.steps / 1e3:9.3f} ms/step  "
                  f"{e.count // args.steps:4d}x  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
