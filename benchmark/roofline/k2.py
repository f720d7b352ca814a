"""K2 (`csrc/yin.cu` `yin_kernel`): YIN pitch and confidence of [B, N]
PCM at `window`/`hop`.

Bytes: the PCM read once, pitch and confidence [B, T] written once.
Operations per frame, the least-work form of the difference function
d = E1 + S - 2 r: r through real FFTs of W points (two forward, one
inverse, 2.5 W log2 W each; a complex product of 6 a bin), E1 and S by a
prefix sum of squares (2 a sample), 3 a lag to combine them (W/2 lags),
then ~10 a lag for the normalized difference and the pick. The
operations bound it: 0.437 ms at B = 128 x 30 s, 1024/512 (a copy of
`chip_smoke.py`'s arithmetic)."""

import math


def frames(n: int, window: int, hop: int) -> int:
    return (n - window) // hop + 1 if n >= window else 0


def counts(batch: int, n: int, window: int, hop: int):
    t = batch * frames(n, window, hop)
    yin = 3 * 2.5 * window * math.log2(window) + 6 * (window // 2 + 1) + 2 * window + 3 * (window // 2)
    return batch * n * 4 + t * 2 * 4, t * (yin + 10 * window // 2)
