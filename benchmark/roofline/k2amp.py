"""K2 with the period amplitude (`csrc/yin.cu` `yin_kernel` with an
amplitude output; `ops/speech.analyze_voice_quality`, 1024/256): YIN
pitch, confidence and the RMS over each frame's first period.

Bytes: the PCM read once, pitch, confidence and amplitude [B, T] written
once. Operations: K2's per frame (`roofline/k2.py`); the amplitude's
sum over one period is a few hundred more a frame and is left out, as
`chip_smoke.py` leaves it out. The operations bound it: 0.874 ms at
B = 128 x 30 s (a copy of `chip_smoke.py`'s arithmetic). Both counts
are linear in the rows, so the counts of several launches are those of
their rows summed."""

from benchmark.roofline import k2


def counts(rows: int, n: int, window: int, hop: int):
    nbytes, ops = k2.counts(rows, n, window, hop)
    return nbytes + rows * k2.frames(n, window, hop) * 4, ops
