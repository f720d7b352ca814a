"""Chord templates (counterpart of the `_CHORD_MATRIX` part of
`sonido_sonar_tpu/ops/tonal.py`; chord_detection.go): one unit-norm
row per (quality, root), qualities in table order, roots C..B."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from sonido_sonar_tpu_torch.ops.chroma import CHROMA_LABELS

# chord quality templates over pitch classes relative to root
CHORD_QUALITIES: Dict[str, List[int]] = {
    "major": [0, 4, 7],
    "minor": [0, 3, 7],
    "diminished": [0, 3, 6],
    "augmented": [0, 4, 8],
    "sus2": [0, 2, 7],
    "sus4": [0, 5, 7],
    "major7": [0, 4, 7, 11],
    "minor7": [0, 3, 7, 10],
    "dominant7": [0, 4, 7, 10],
}


def chord_template_matrix() -> Tuple[np.ndarray, List[Tuple[str, str]]]:
    """([n_chords, 12] float32 templates, [(root, quality)] labels)."""
    rows, labels = [], []
    for quality, intervals in CHORD_QUALITIES.items():
        base = np.zeros(12)
        base[intervals] = 1.0
        base /= np.linalg.norm(base)
        for root in range(12):
            rows.append(np.roll(base, root))
            labels.append((CHROMA_LABELS[root], quality))
    return np.stack(rows).astype(np.float32), labels


CHORD_MATRIX, CHORD_LABELS = chord_template_matrix()


def chord_matrix() -> np.ndarray:
    """The [n_chords, 12] templates (a table for `ops/tables.device_table`)."""
    return CHORD_MATRIX
