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
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seconds", type=int, default=30)
    ap.add_argument("--steps", type=int, default=3)
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
