#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold each
CUDA kernel to its plain PyTorch version.

    python3 chip_smoke.py

Run from the root of a checkout; it builds the kernels from the sources
in the checkout (nvcc, sm_90a) and needs one CUDA card. Phases, in order
(every failure raises, so the exit code is nonzero):

  1. the card's name and power limit (nvidia-smi)
  2. require CUDA; TF32 off
  3. build the kernels
  4. K1 (STFT + aux) against its plain version, B=4 x 5 s and B=128 x 30 s
  5. K2 (YIN) against its plain version, same inputs; then both at other
     windows, hops and pre-emphasis values, and on a 1-D row
  6. the main path, batched_fingerprint_features, at B=128 x 30 s,
     44.1 kHz, window 1024, hop 256: shapes, finite values, kernel launch
     counts, step time and audio-hours per wall-hour
  7. the main path at [2, 44100] on the card against the CPU
  8. K1 and K2 against their plain versions, timed at the main path's shapes

The second-to-last line is {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Inputs are harmonic tones plus noise (utils/parity.synth_pcm), drawn
with numpy from SEED.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
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
OUTPUT_KEYS = (
    "mfcc", "chroma", "spectral_centroid", "spectral_bandwidth", "spectral_flatness",
    "spectral_crest", "spectral_slope", "spectral_flux", "spectral_contrast", "zcr",
    "spectral_rolloff", "low_energy_ratio", "high_energy_ratio", "rms_energy",
    "energy_entropy", "energy_variance", "pitch", "pitch_confidence", "voicing",
)


def log(msg: str) -> None:
    print(msg, flush=True)


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
    from sonido_sonar_tpu_torch.ops import hopper_stft, hopper_yin
    from sonido_sonar_tpu_torch.parallel.pipeline import batched_fingerprint_features
    from sonido_sonar_tpu_torch.utils import parity

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    _, info = _build.build()                                  # phase 3
    log(f"built {info.path.name} in {info.seconds:.1f} s")
    log(info.compiler_log.strip())

    k1 = hopper_stft.stft_magnitude_hopper
    k1_plain = hopper_stft.stft_magnitude_plain
    k2 = hopper_yin.yin_pitch_hopper
    k2_plain = hopper_yin.yin_pitch_plain
    k2_args = (PITCH_WINDOW, PITCH_HOP, SR, 80.0, 1000.0, 0.15, PRE_EMPH)

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
    # the kernels' other geometries and options, and a 1-D row
    odd = parity.synth_pcm(3, SR + 777, SEED + 3, SR, dev)
    for w, hop, pre in ((512, 128, 0.0), (2048, 512, 0.95), (256, 100, 0.97)):
        hold_k1(odd, w, hop, pre)
        hold_k2(odd, w, hop, pre)
    mag1, aux1 = k1(odd[1], WINDOW, HOP, pre_emph=PRE_EMPH)
    mag3, aux3 = k1(odd, WINDOW, HOP, pre_emph=PRE_EMPH)
    p1 = k2(odd[1], *k2_args)[0]
    if not (torch.equal(mag1, mag3[1]) and torch.equal(aux1["rms"], aux3["rms"][1])
            and torch.equal(p1, k2(odd, *k2_args)[0][1])):
        raise AssertionError("a 1-D row and the same row in a batch differ")
    log("[K1, K2 on a 1-D row] equal to the same row in a batch")

    t_frames = (FULL_SECONDS * SR - WINDOW) // HOP + 1        # phase 6
    t_pitch = (FULL_SECONDS * SR - PITCH_WINDOW) // PITCH_HOP + 1
    k1.launches = 0
    k2.launches = 0
    out = batched_fingerprint_features(full, sample_rate=SR, window_size=WINDOW, hop_size=HOP)
    torch.cuda.synchronize()
    launches = {"K1": k1.launches, "K2": k2.launches}
    log(f"main path launches: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path was not launched: {launches}")
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
    del out
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

    times = {}                                                # phase 8
    for name, kern, plain, args in (
        ("K1", k1, k1_plain, (WINDOW, HOP, "hann", PRE_EMPH)),
        ("K2", k2, k2_plain, k2_args),
    ):
        kern(full, *args), plain(full, *args)  # warm-up
        p1 = cuda_ms(lambda: plain(full, *args), 3)
        q1 = cuda_ms(lambda: kern(full, *args), 10)
        q2 = cuda_ms(lambda: kern(full, *args), 10)
        p2 = cuda_ms(lambda: plain(full, *args), 3)
        times[name] = ((q1 + q2) / 2, (p1 + p2) / 2)
        log(f"{name} at {tuple(full.shape)}: kernel {q1:.3f} / {q2:.3f} ms, "
            f"plain {p1:.3f} / {p2:.3f} ms [{card}]")
        torch.cuda.empty_cache()

    for mod in ("jax", "sonido_sonar_tpu"):
        if mod in sys.modules:
            raise AssertionError(f"{mod} was imported")
    kernels = [
        {"name": "K1 stft_magnitude_aux", "route": "cuda",
         "source": "sonido_sonar_tpu_torch/csrc/stft.cu",
         "replaces": "sonido_sonar_tpu/ops/pallas_stft.py:145",
         "launches": launches["K1"], "max_abs_err": errs["K1", "full"]["magnitude"],
         "ms": times["K1"][0], "plain_ms": times["K1"][1]},
        {"name": "K2 yin_pitch", "route": "cuda",
         "source": "sonido_sonar_tpu_torch/csrc/yin.cu",
         "replaces": "sonido_sonar_tpu/ops/pallas_yin.py:238",
         "launches": launches["K2"], "max_abs_err": errs["K2", "full"]["pitch_max_abs"],
         "ms": times["K2"][0], "plain_ms": times["K2"][1]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
