"""Audio value objects (counterpart of `sonido_sonar_tpu/io/audio.py`;
transcode/decoder.go:21-64,117-143).

The port keeps its own copy: the JAX package's `io/` sits under a
package whose `__init__` imports JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Union

import numpy as np
import torch


@dataclass
class StreamMetadata:
    """Probe results for one stream (decoder.go:117-130)."""

    codec: str = ""
    sample_rate: int = 0
    channels: int = 0
    duration: float = 0.0
    bit_rate: int = 0
    format_name: str = ""


@dataclass
class AudioMetadata:
    """Container-level metadata (decoder.go:132-143)."""

    url: str = ""
    format_name: str = ""
    duration: float = 0.0
    bit_rate: int = 0
    sample_rate: int = 0
    channels: int = 0
    codec: str = ""
    genre: str = ""
    station: str = ""
    title: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class AudioData:
    """Decoded mono PCM (decoder.go:21-36).

    `pcm` is a 1-D float32 numpy array or torch tensor (a CUDA row
    included); the generator stacks a batch into one [B, N] tensor.
    """

    pcm: Union[np.ndarray, torch.Tensor]
    sample_rate: int
    channels: int = 1
    metadata: Optional[AudioMetadata] = None

    @property
    def duration(self) -> float:
        return len(self.pcm) / float(self.sample_rate)

    def __len__(self) -> int:
        return len(self.pcm)


def host_pcm(pcm) -> np.ndarray:
    """A clip's PCM (numpy array or tensor, on any device) as host numpy."""
    if isinstance(pcm, torch.Tensor):
        return pcm.detach().cpu().numpy()
    return np.asarray(pcm)
