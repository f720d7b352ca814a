#!/usr/bin/env python3
"""Fingerprint and time K4 (onset thinning) and K9 (contrast band means)
of one tree of the port.

    python3 tools/time_onsets_contrast.py TAG [--root DIR] [--iters 50]

Builds the kernels of the `sonido_sonar_tpu_torch` package under DIR
(default: the checkout this script is in) and runs, through that tree's
wrappers, on inputs made from seed 1:
- K4 on the music step's flux candidates (K1 magnitudes of
  utils/parity.synth_pcm at B=128 x 30 s, 44.1 kHz, 1024/256, then
  spectral flux and the 0.3 peak pick; [128, 5163], min_frames 8) and on
  random candidates at [128, 5163] (density 0.3, min_frames 8) and
  [128, 5165] (0.05, min_frames 4);
- K9 on those K1 magnitudes, [128, 5164, 513] with the 6 contrast edges,
  and at W = 2048 ([128, 1290, 1025], hop 1024).
Prints one JSON line: per input a hash of the outputs (K4's must be equal
between trees: its output is bit-identical to the recurrence), whether
two launches gave the same bits, K9's largest relative error against its
plain version (utils/parity.check_band_means), the times in ms (CUDA
events around the wrapper's calls, mean of --iters calls after one
warm-up, two windows) and the kernel's own device time (torch.profiler,
mean over --iters launches, by this checkout's utils/parity.device_ms
whatever the tree; for K4 the wrapper's host work is longer than the
kernel). To compare trees on one card, run it from each in one
command, in turns (parent, change, change, parent). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def sha(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tag")
    ap.add_argument("--root", default=str(HERE.parent))
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_onsets_contrast: needs a CUDA device")
    # the profiler helper from this checkout's utils/parity (torch only),
    # loaded by path so that a tree without it is timed the same way
    spec = importlib.util.spec_from_file_location(
        "parity_of_this_checkout", HERE.parent / "sonido_sonar_tpu_torch" / "utils" / "parity.py")
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    sys.path.insert(0, args.root)
    from sonido_sonar_tpu_torch import _build
    from sonido_sonar_tpu_torch.ops import hopper_contrast, hopper_onsets
    from sonido_sonar_tpu_torch.ops import temporal as T
    from sonido_sonar_tpu_torch.ops.hopper_stft import stft_magnitude_hopper as k1
    from sonido_sonar_tpu_torch.ops.spectral import contrast_band_edges
    from sonido_sonar_tpu_torch.ops.stft import spectral_flux
    from sonido_sonar_tpu_torch.utils import parity

    t0 = time.perf_counter()
    _build.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"tag": args.tag, "card": card, "build_s": round(time.perf_counter() - t0, 1)}

    def ms(fn, kernel):
        """(ms per call by CUDA events around the wrapper's calls, the two
        windows, ms of the kernel itself on the device by torch.profiler):
        a kernel shorter than the wrapper's host work shows its own time
        only in the profiler."""
        fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(2):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(args.iters):
                fn()
            b.record()
            torch.cuda.synchronize()
            runs.append(a.elapsed_time(b) / args.iters)
        dev = timing.device_ms(fn, kernel, args.iters)
        return round(sum(runs) / 2, 5), [round(r, 5) for r in runs], round(dev, 5)

    k4 = hopper_onsets.thin_onsets_hopper
    k9 = hopper_contrast.band_select_means_hopper
    x = parity.synth_pcm(128, 30 * 44100, 1, 44100, "cuda")
    mag = k1(x, 1024, 256, pre_emph=0.97)[0]
    flux = T.flux_onset_candidates(spectral_flux(mag), 0.3).contiguous()
    rng = np.random.default_rng(1)
    onsets = {
        "flux": (flux, 8),
        "rand30": (torch.from_numpy(rng.random((128, 5163)) < 0.3).cuda(), 8),
        "rand05_mf4": (torch.from_numpy(rng.random((128, 5165)) < 0.05).cuda(), 4),
    }
    for name, (cand, mf) in onsets.items():
        kept = k4(cand, mf)
        t, runs, dev = ms(lambda: k4(cand, mf), "thin_kernel")
        out[f"K4_{name}"] = {"kept_sha": sha(kept), "repeat_bit_equal": bool(torch.equal(kept, k4(cand, mf))),
                             "candidates": int(cand.sum()), "kept": int(kept.sum()), "ms": t, "runs": runs,
                             "device_ms": dev}
    del flux, onsets
    x2 = parity.synth_pcm(128, 30 * 44100, 2, 44100, "cuda")
    contrast = {"w1024": mag, "w2048": k1(x2, 2048, 1024, pre_emph=0.97)[0]}
    del x, x2
    for name, m in contrast.items():
        edges = contrast_band_edges(6, m.shape[-1], 44100)
        peak, valley = k9(m, edges)
        again = k9(m, edges)
        ppeak, pvalley = hopper_contrast.band_select_means_plain(m, edges)
        errors, failures = parity.check_band_means(*(t.cpu().numpy() for t in (peak, valley, ppeak, pvalley)))
        t, runs, dev = ms(lambda: k9(m, edges), "band_means")
        out[f"K9_{name}"] = {"shape": list(m.shape), "edges": list(edges), "sha": sha(peak, valley),
                             "repeat_bit_equal": bool(torch.equal(peak, again[0]) and torch.equal(valley, again[1])),
                             "max_rel_err": max(errors.values()), "parity_ok": not failures,
                             "ms": t, "runs": runs, "device_ms": dev}
        del peak, valley, again, ppeak, pvalley
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
