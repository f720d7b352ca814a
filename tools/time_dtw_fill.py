#!/usr/bin/env python3
"""Fingerprint and time the banded DTW fill and backtrack of one tree of
the port.

    python3 tools/time_dtw_fill.py TAG [--root DIR]

Builds the kernels of the `sonido_sonar_tpu_torch` package under DIR
(default: the checkout this script is in) and runs its
`fill_banded_hopper` on seeded inputs at K6's geometry [8, 2048, 12]
band 64, K7's [1, 10335, 12] band 5167, the fleet's [2, 10332, 1] and
[32, 10332, 1] band 5167 and the wide band [2, 3000 x 2900, 1] band
20671, then `backtrack_banded_hopper` on each fill's band. Prints one
JSON line: per geometry a hash of the cost band (equal hashes: bit-equal
fills; none at B = 32) and of the walk's four outputs (equal hashes:
bit-equal walks), and the times in ms (CUDA events, mean of two calls
after one warm-up) of the distance pre-pass, the row recurrence and the
whole fill call (or of the whole call alone for a tree whose fill is
one kernel), and of the walk, warm and with the L2 cache overwritten
before each call (as the walk finds it right after a fill). To compare trees on one card, run it from
each in one command, in turns (parent, change, change, parent).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tag")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_dtw_fill: needs a CUDA device")
    sys.path.insert(0, args.root)
    from sonido_sonar_tpu_torch import _build
    from sonido_sonar_tpu_torch.ops.stats import hopper_dtw as H
    from sonido_sonar_tpu_torch.ops.stats.hopper_backtrack import backtrack_banded_hopper as walk

    t0 = time.perf_counter()
    _build.build()
    out = {"tag": args.tag, "build_s": round(time.perf_counter() - t0, 1)}
    rng = np.random.default_rng(5)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()

    def ms(fn, iters=2):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return round(a.elapsed_time(b) / iters, 3)

    flush = torch.empty(2**26, dtype=torch.float32, device="cuda")  # 256 MiB, past the L2

    def cold_ms(fn, iters=2):
        total = 0.0
        for _ in range(iters):
            flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            total += a.elapsed_time(b)
        return round(total / iters, 3)

    cases = {"K6": (rand(8, 2048, 12), None, 64), "K7": (rand(1, 10335, 12), None, 5167),
             "fleet": (rand(2, 10332, 1).abs(), None, 5167),
             "wide": (rand(2, 3000, 1), rand(2, 2900, 1), 20671),
             "B32": (rand(32, 10332, 1).abs(), None, 5167)}
    split = hasattr(H, "local_distances_hopper")
    for name, (q, r, band) in cases.items():
        r = torch.roll(q, 7, 1).contiguous() if r is None else r
        n, m = q.shape[1], r.shape[1]
        cost = H.fill_banded_hopper(q, r, band, n, m)
        if name != "B32":
            out[name + "_sha"] = hashlib.sha256(cost.cpu().numpy().tobytes()).hexdigest()[:16]
        path = walk(cost, band, n, m)
        out[name + "_walk_sha"] = hashlib.sha256(
            b"".join(t.cpu().numpy().tobytes() for t in path)).hexdigest()[:16]
        walk_ms = ms(lambda: walk(cost, band, n, m))
        walk_cold_ms = cold_ms(lambda: walk(cost, band, n, m))
        del cost, path
        whole = ms(lambda: H.fill_banded_hopper(q, r, band, n, m))
        if split:
            local = H.local_distances_hopper(q, r, band, n, m)
            out[name] = {"prepass_ms": ms(lambda: H.local_distances_hopper(q, r, band, n, m)),
                         "rows_ms": ms(lambda: H.fill_rows_hopper(local, band, n, m)),
                         "whole_ms": whole}
            del local
        else:
            out[name] = {"whole_ms": whole}
        out[name]["walk_ms"] = walk_ms
        out[name]["walk_l2_flushed_ms"] = walk_cold_ms
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
