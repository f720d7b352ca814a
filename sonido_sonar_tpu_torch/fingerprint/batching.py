"""Ragged-corpus bucketing for batched fingerprint generation
(counterpart of `sonido_sonar_tpu/fingerprint/batching.py`).

The reference's `GenerateFingerprint` accepts any single clip
(fingerprint.go:137); the batch path takes equal-length, same-rate rows.
`batch_audios` groups a mixed corpus by sample rate and pads lengths
into power-of-two buckets (the JAX package's bucketing, kept so both
packages fingerprint the same padded rows), and
`FingerprintGenerator.generate_fingerprints_mixed` (generator.py) runs
the buckets and restores input order.

Padding semantics: a clip is zero-padded to its bucket length, so its
trailing frames see silence — the same thing the reference's own STFT
does at a clip's tail, extended to the bucket boundary. Frame-level
features over the original span are unchanged; whole-clip scalars
(tempo, loudness range, energy variance) are computed over the padded
length. `AudioBucket.valid_lengths` carries the original sample counts
for consumers that want to re-mask. Fingerprint metadata (duration,
IDs) always reflects the ORIGINAL clip.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from sonido_sonar_tpu_torch.io.audio import AudioData, host_pcm


@dataclass
class AudioBucket:
    """One fixed-shape batch of a mixed corpus."""

    audios: List[AudioData]     # original clips (original lengths/metadata)
    indices: List[int]          # positions in the input list
    pcm_matrix: np.ndarray      # [G, N] float32, rows zero-padded to N
    valid_lengths: np.ndarray   # [G] original sample counts
    sample_rate: int


def _bucket_len(n: int, quantum: int) -> int:
    """Power-of-two bucket length (>= quantum) covering n samples."""
    b = quantum
    while b < n:
        b <<= 1
    return b


def batch_audios(
    audios,
    max_batch: int = 0,
    quantum: int = 16384,
) -> List[AudioBucket]:
    """Group a mixed-length, mixed-rate corpus into fixed-shape buckets.

    Clips are grouped by (sample_rate, power-of-two padded length) —
    the number of distinct batch shapes is bounded by
    #rates x log2(max length / quantum) regardless of corpus size.
    `max_batch` > 0 additionally splits oversized groups. Bucket order
    is deterministic (first-seen); `indices` lets callers restore input
    order.

    Feed each bucket to `generate_fingerprints_batch(bucket.audios,
    pcm_matrix=bucket.pcm_matrix)`, or use
    `FingerprintGenerator.generate_fingerprints_mixed`, which does both
    and restores order.
    """
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, a in enumerate(audios):
        if a is None or len(a.pcm) == 0:
            raise ValueError("audio data cannot be empty")
        key = (a.sample_rate, _bucket_len(len(a.pcm), quantum))
        groups.setdefault(key, []).append(i)

    buckets: List[AudioBucket] = []
    for (sr, n), idxs in groups.items():
        for lo in range(0, len(idxs), max_batch or len(idxs)):
            part = idxs[lo : lo + (max_batch or len(idxs))]
            mat = np.zeros((len(part), n), dtype=np.float32)
            lens = np.zeros(len(part), dtype=np.int64)
            for row, i in enumerate(part):
                pcm = host_pcm(audios[i].pcm).astype(np.float32)
                mat[row, : len(pcm)] = pcm
                lens[row] = len(pcm)
            buckets.append(
                AudioBucket(
                    audios=[audios[i] for i in part],
                    indices=list(part),
                    pcm_matrix=mat,
                    valid_lengths=lens,
                    sample_rate=sr,
                )
            )
    return buckets
