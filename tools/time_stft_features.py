#!/usr/bin/env python3
"""Fingerprint and time K1 and its feature epilogue K10 of one tree of
the port.

    python3 tools/time_stft_features.py TAG [--root DIR] [--iters 20]

Builds the kernels of the `sonido_sonar_tpu_torch` package under DIR
(default: the checkout this script is in) and runs its
`stft_magnitude_hopper` with and without the feature epilogue on
utils/parity.synth_pcm (seed 1) at the main path's B=128 x 30 s, 44.1
kHz, 1024/256, pre-emphasis 0.97, and at smaller geometries (64/16 and
2048/512 at 44.1 kHz, 256/100 at 16 kHz). Prints one JSON line: per
geometry a hash of the magnitudes and aux planes (equal hashes: K1
bit-equal between trees) and of feat (equal only for trees that sum in
the same order), whether two launches gave the same feat bits, and at
the main shape the times in ms (CUDA events, mean of --iters calls after
one warm-up, K1 and K10 alternated twice) of K1, K10 and their
difference, the epilogue's share. To compare trees on one card, run it
from each in one command, in turns (parent, change, change, parent).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

GEOMETRIES = {  # name -> (batch, seconds, sample rate, window, hop)
    "main": (128, 30, 44100, 1024, 256),
    "w64": (4, 5, 44100, 64, 16),
    "w256_16k": (4, 5, 16000, 256, 100),
    "w2048": (4, 5, 44100, 2048, 512),
}


def sha(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tag")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_stft_features: needs a CUDA device")
    sys.path.insert(0, args.root)
    from sonido_sonar_tpu_torch import _build
    from sonido_sonar_tpu_torch.ops.hopper_stft import stft_magnitude_hopper as k1
    from sonido_sonar_tpu_torch.utils.parity import synth_pcm

    t0 = time.perf_counter()
    _build.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"tag": args.tag, "card": card, "build_s": round(time.perf_counter() - t0, 1)}

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(args.iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / args.iters

    for name, (batch, seconds, sr, w, hop) in GEOMETRIES.items():
        x = synth_pcm(batch, seconds * sr, 1, sr, "cuda")
        kw = dict(pre_emph=0.97, with_features=True, sample_rate=sr)
        mag, aux, feat = k1(x, w, hop, **kw)
        again = k1(x, w, hop, **kw)[2]
        entry = {"mag_aux_sha": sha(mag, *aux.values()), "feat_sha": sha(feat),
                 "repeat_bit_equal": bool(torch.equal(feat, again))}
        del mag, aux, feat, again
        if name == "main":
            t1, t10 = [], []
            for _ in range(2):
                t1.append(ms(lambda: k1(x, w, hop, pre_emph=0.97)))
                t10.append(ms(lambda: k1(x, w, hop, **kw)))
            entry.update(k1_ms=round(sum(t1) / 2, 4), k10_ms=round(sum(t10) / 2, 4),
                         epilogue_ms=round((sum(t10) - sum(t1)) / 2, 4),
                         k1_runs=[round(t, 4) for t in t1], k10_runs=[round(t, 4) for t in t10])
        out[name] = entry
        del x
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
