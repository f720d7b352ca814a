"""Fleet-scale CDN latency monitoring: B stream pairs in one step.

Aligns B source/CDN stream pairs at once — frame-level coarse offsets
from batched energy cross-correlation, then exact-sample GCC-PHAT
refinement — the production shape of the reference's one-pair
AlignAudioFiles loop (alignment.go:489-553) on a batch axis.

Usage: python -m sonido_sonar_tpu_torch.examples.batch_monitor [n_pairs] [seconds]
(synthesizes pairs with known offsets and reports recovery; `main`
returns the exact-sample count and the timed step's ms).
"""

import sys
import time

import numpy as np

from sonido_sonar_tpu_torch.io.synth import harmonic_tone, shift_signal, white_noise
from sonido_sonar_tpu_torch.ops.temporal import short_time_energy
from sonido_sonar_tpu_torch.parallel import batched_pair_alignment, batched_refine_offsets
from sonido_sonar_tpu_torch.utils.device import DEFAULT_DEVICE, Device, as_float32


def main(n_pairs: int = 8, seconds: float = 12.0, device: Device = DEFAULT_DEVICE) -> dict:
    sr = 44100
    hop = 256
    rng = np.random.default_rng(42)

    base = np.asarray(
        harmonic_tone(220.0, seconds, sr) + white_noise(seconds, sr, 0.05, seed=1)
    )
    env = np.interp(
        np.arange(len(base)),
        np.linspace(0, len(base), int(8 * seconds)),
        rng.uniform(0.1, 1.0, int(8 * seconds)),
    )
    src = (base * env).astype(np.float32)

    max_off = int(seconds * sr / 4)
    true_lags = rng.integers(-max_off, max_off, n_pairs)
    queries = np.stack([src] * n_pairs)
    refs = np.stack(
        [shift_signal(src, int(l), noise=0.02, gain=0.9) for l in true_lags]
    ).astype(np.float32)

    q_t, r_t = as_float32(queries, device), as_float32(refs, device)
    max_lag_frames = max_off // hop + 2

    # warm up, then time one monitoring step (it ends in host reads)
    def step():
        e1 = short_time_energy(q_t, 1024, hop)
        e2 = short_time_energy(r_t, 1024, hop)
        coarse_frames = batched_pair_alignment(e1, e2, max_lag=max_lag_frames)
        coarse_s = coarse_frames["lag_frames"].cpu().numpy() * hop / sr
        refined = batched_refine_offsets(
            q_t, r_t, as_float32(coarse_s, q_t.device), sr, hop_size=hop,
            max_offset_samples=max_off + hop,
        )
        return refined.cpu().numpy(), coarse_frames["peak_correlation"].cpu().numpy()

    step()
    t0 = time.perf_counter()
    refined, peak_corr = step()
    dt = (time.perf_counter() - t0) * 1000

    got = np.round(refined * sr).astype(int)
    print(f"{n_pairs} pairs x {seconds:.0f}s monitored in {dt:.1f} ms")
    for i in range(n_pairs):
        err = abs(got[i] - true_lags[i])
        print(
            f"  pair {i}: latency {refined[i]*1000:9.3f} ms "
            f"(true {true_lags[i]/sr*1000:9.3f} ms, err {err} samples, "
            f"corr {peak_corr[i]:.2f})"
        )
    exact = int((got == true_lags).sum())
    print(f"exact-sample recovery: {exact}/{n_pairs}")
    return {"exact": exact, "pairs": n_pairs, "ms": dt}


if __name__ == "__main__":
    main(
        int(sys.argv[1]) if len(sys.argv) > 1 else 8,
        float(sys.argv[2]) if len(sys.argv) > 2 else 12.0,
    )
