"""K4 (`csrc/onsets.cu` `thin_kernel`): min-interval onset thinning of
[R, T] bool candidates into a [R, T] bool kept mask.

Bytes: each cell's candidate read once and its kept flag written once,
one byte each. Operations: an integer decision per candidate, left out
(the bytes bound it). The bytes bound it: 0.79 us for the music
program's three launches a batch at B = 128 x 30 s, 2048/512 (128 x
(2,580 + 2,582 + 5,166) cells). The counts are linear in the cells, so
the counts of several launches are those of their cells summed
(`thin_onsets_hopper.cells`)."""


def counts(cells: int):
    return 2 * cells, 0
