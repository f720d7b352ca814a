"""FingerprintModel: the main path's forward step as a module
(counterpart of `sonido_sonar_tpu/models/pipeline.py`).

A `torch.nn.Module` without parameters: `model(pcm)` is
`batched_fingerprint_features` with the model's FeatureConfig and
device (numpy input goes there, a tensor keeps its own), so it
follows the feature-epilogue configuration when the environment asks for
it (`parallel/pipeline.feat_epilogue_enabled`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from sonido_sonar_tpu_torch.config.config import FeatureConfig
from sonido_sonar_tpu_torch.parallel.pipeline import batched_fingerprint_features
from sonido_sonar_tpu_torch.utils.device import DEFAULT_DEVICE, Device


class FingerprintModel(torch.nn.Module):
    """Content-agnostic fingerprint forward step; the geometry defaults to
    window 1024 / hop 256 at 44.1 kHz, the JAX benchmark's shape."""

    def __init__(self, config: Optional[FeatureConfig] = None, enable_pitch: bool = True,
                 device: Device = DEFAULT_DEVICE):
        super().__init__()
        self.config = config or FeatureConfig(window_size=1024, hop_size=256)
        self.enable_pitch = enable_pitch
        self.device = torch.device(device)

    def forward(self, pcm: torch.Tensor) -> Dict[str, torch.Tensor]:
        cfg = self.config
        return batched_fingerprint_features(
            pcm,
            sample_rate=cfg.sample_rate,
            window_size=cfg.window_size,
            hop_size=cfg.hop_size,
            window_type=cfg.window_type,
            mfcc_coefficients=cfg.mfcc_coefficients,
            enable_chroma=cfg.enable_chroma,
            enable_contrast=cfg.enable_spectral_contrast,
            enable_pitch=self.enable_pitch,
            device=self.device,
        )
