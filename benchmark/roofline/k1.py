"""K1 (`csrc/stft.cu` `stft_aux_kernel`): the STFT magnitudes and the
five aux series of [B, N] PCM in one pass.

Bytes: the PCM read once, the magnitudes [B, T, W/2 + 1] and the aux
[5, B, T] written once. Operations per frame: the window, an FFT of W/2
complex points (5 (W/2) log2(W/2)), the real split and magnitude (~20 a
bin), the aux sums (~4 a bin, 3 a sample). The bytes bound it: 0.611 ms
at B = 128 x 30 s, 1024/256 (a copy of `chip_smoke.py`'s arithmetic)."""

import math


def frames(n: int, window: int, hop: int) -> int:
    return (n - window) // hop + 1 if n >= window else 0


def counts(batch: int, n: int, window: int, hop: int):
    """(bytes, operations) of one launch."""
    t = batch * frames(n, window, hop)
    bins = window // 2 + 1
    ops_frame = window + 5 * (window // 2) * math.log2(window // 2) + 24 * bins + 3 * window
    return batch * n * 4 + t * (bins + 5) * 4, t * ops_frame
