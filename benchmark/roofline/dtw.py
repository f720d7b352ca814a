"""The banded DTW as one unit (`csrc/dtw.cu`: the distance pre-pass, the
row recurrence and the backtrack), whatever implements it.

Operations: each band cell of each pair, [B, n + 1, 2 band + 1], takes a
local distance (|q|^2 + |r|^2 - 2 q r and a square root: ~5), a
three-way min (2) and an add (1): 8. Bytes: the two series read once and
the path (q index, r index, cost: 12 bytes a step, at most n + m steps)
written once; the cost band between the passes is the implementation's,
not the work's. At the fleet's sub-batch (32 pairs, n = m = 10,332,
band 5,167) the operations bound it: 0.408 ms a launch."""


def counts(batch: int, n: int, m: int, band: int, dims: int = 1):
    cells = batch * (n + 1) * (2 * band + 1)
    return batch * (n + m) * dims * 4 + batch * (n + m) * 12, cells * 8
