"""Fingerprint generation: the public entry point (counterpart of
`sonido_sonar_tpu/fingerprint/generator.py`).

Reference parity: fingerprint/fingerprint.go —
  GenerateFingerprint (:137-236): content detect -> per-content config ->
  extractor -> features -> AudioFingerprint{ID (sha256 of time + length
  + rate, utils.go:21-28), URL, content type, duration, sample rate,
  hop size, channels, features, metadata (utils.go:30-58)}; defaults
  window 2048 / hop 512 (:70-98).

The per-clip and the batched path run the same extractor (`_extract`):
the speech and music extractors' single programs (`extractors/programs.py`,
`parallel/pipeline.py`), and for sports and mixed content the class
composition over `ops.stft.stft`; so a batch equals its clips
fingerprinted one by one. Compute runs where the PCM is: a tensor
stays on its device, numpy PCM goes to the generator's `device` (the card
unless the caller asks for the CPU; `utils/device.py`).
"""

from __future__ import annotations

import hashlib
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from sonido_sonar_tpu_torch.config.config import (
    ContentType,
    FingerprintConfig,
    default_fingerprint_config,
    to_content_type,
)
from sonido_sonar_tpu_torch.config.content_config import ContentAwareConfigManager
from sonido_sonar_tpu_torch.extractors.base import FeatureExtractorFactory
from sonido_sonar_tpu_torch.extractors.features import ExtractedFeatures, map_tensors
from sonido_sonar_tpu_torch.fingerprint.content_detector import ContentDetector
from sonido_sonar_tpu_torch.io.audio import AudioData
from sonido_sonar_tpu_torch.ops.stft import stft
from sonido_sonar_tpu_torch.utils.device import DEFAULT_DEVICE, Device, as_float32
from sonido_sonar_tpu_torch.utils.metrics import Span, count_host_sync

_log = logging.getLogger(__name__)

DETECT = Span("generator.detect")          # the detector's feature pass and its copy, launched
EXTRACT = Span("generator.extract")        # one extractor call (speculative ones included)
MATERIALIZE = Span("generator.materialize")  # the host pulls of a batch's group features
ASSEMBLE = Span("generator.assemble")      # the per-clip fingerprint objects and feature views


@dataclass
class AudioFingerprint:
    """AudioFingerprint (fingerprint.go:14-26)."""

    id: str
    stream_url: str
    content_type: ContentType
    timestamp: float
    duration: float
    sample_rate: int
    hop_size: int
    channels: int
    features: Optional[ExtractedFeatures]
    metadata: Dict[str, Any] = field(default_factory=dict)


def generate_id(audio: AudioData) -> str:
    """utils.go:21-28: sha256(time_ns, len, rate)[:16]."""
    h = hashlib.sha256(f"{time.time_ns()}_{len(audio.pcm)}_{audio.sample_rate}".encode())
    return h.hexdigest()[:16]


@dataclass
class FingerprintBatch:
    """Result of `generate_fingerprints_batch(materialize=False)`: the
    per-group features stay on the device ([G, ...] tensors) and
    `fingerprints` carries every clip's metadata with `features=None`
    until `materialize()`."""

    fingerprints: List[AudioFingerprint]
    groups: List[Tuple[ContentType, List[int], ExtractedFeatures]]
    _cm_cache: Optional[Tuple[int, torch.Tensor]] = field(default=None, init=False, repr=False)

    def materialize(self) -> List[AudioFingerprint]:
        """Fill every fingerprint's `features` with host numpy (each
        tensor of a group pulled once, then per-clip views) and return
        the list."""
        for _, idxs, features in self.groups:
            with MATERIALIZE:
                feats_np = map_tensors(_pull, features)
            with ASSEMBLE:
                for pos, i in enumerate(idxs):
                    self.fingerprints[i].features = map_tensors(lambda a, p=pos: a[p], feats_np)
        return self.fingerprints

    def comparator_matrix(self, num_mfcc_coeffs: int = 13) -> torch.Tensor:
        """Packed comparator statistics [B, D] float32 in the
        `device_compare` layout, on the features' device: the
        corpus-ready output without the features leaving it. Row order
        matches `fingerprints`. A single group (every clip one content
        type, the common corpus) is its pack as it is; several groups
        are packed per group, then put back in clip order by one gather
        on the inverse permutation. Cached per `num_mfcc_coeffs`."""
        if self._cm_cache is not None and self._cm_cache[0] == num_mfcc_coeffs:
            return self._cm_cache[1]
        from sonido_sonar_tpu_torch.fingerprint.device_compare import pack_comparator_stats_batch

        packs = [pack_comparator_stats_batch(features, num_mfcc_coeffs)
                 for _, _, features in self.groups]
        if len(packs) == 1:
            out = packs[0]
        else:
            order = np.concatenate([np.asarray(idxs, np.int64) for _, idxs, _ in self.groups])
            inv = torch.as_tensor(np.argsort(order), device=packs[0].device)
            out = torch.cat(packs).index_select(0, inv)
        self._cm_cache = (num_mfcc_coeffs, out)
        return out


def _pull(t: torch.Tensor) -> np.ndarray:
    """One feature tensor copied to host numpy: a wait on the card."""
    count_host_sync()
    return t.detach().cpu().numpy()


class FingerprintGenerator:
    """FingerprintGenerator (fingerprint.go:28-135)."""

    def __init__(
        self,
        config: Optional[FingerprintConfig] = None,
        strict_reference_routing: bool = True,
        device: Device = DEFAULT_DEVICE,
    ):
        self.config = config or default_fingerprint_config()
        self.device = torch.device(device)
        self.content_manager = ContentAwareConfigManager(self.config)
        self.content_detector = ContentDetector(self.config.content_aware, device=self.device)
        self.extractor_factory = FeatureExtractorFactory(strict_reference_routing)
        # speculative routing: the detected type of the last all-one-type
        # batch (None after a mixed batch or on a cold start)
        self._spec_ct: Optional[ContentType] = None

    def _as_tensor(self, pcm) -> torch.Tensor:
        """[.., N] PCM as a float32 tensor: a tensor on its own device,
        numpy on the generator's device."""
        return as_float32(pcm, self.device)

    @staticmethod
    def _explicit_type(audio: AudioData) -> ContentType:
        if audio.metadata is not None:
            explicit = audio.metadata.extra.get("content_type", "")
            if explicit:
                return to_content_type(explicit)
        return ContentType.UNKNOWN

    def _detect_content_type(self, audio: AudioData) -> ContentType:
        """Explicit metadata -> acoustic -> UNKNOWN (fingerprint.go:149-170)."""
        content_type = self._explicit_type(audio)
        if content_type == ContentType.UNKNOWN and self.config.content_aware.enable_content_detection:
            content_type = self.content_detector.detect_content_type(audio)
        return content_type

    def _detect_content_types_batch_async(self, audios, pcm_all: torch.Tensor):
        """`_detect_content_type` over a batch, split in two: explicit
        metadata on the host now, one acoustic feature pass launched for
        the rest; the returned `resolve()` classifies. Returns (resolve,
        dispatched); `dispatched=False` means resolve() needs nothing
        from the device (all explicit metadata, or detection off)."""
        ctypes = [self._explicit_type(a) for a in audios]
        pending = [
            i for i, ct in enumerate(ctypes)
            if ct == ContentType.UNKNOWN and self.config.content_aware.enable_content_detection
        ]
        inner = None
        dispatched = False
        if pending:
            sub = pcm_all if len(pending) == len(audios) else pcm_all[
                torch.tensor(pending, device=pcm_all.device)]
            inner, dispatched = self.content_detector.detect_batch_async(
                [audios[i] for i in pending], pcm_device=sub
            )

        def resolve() -> List[ContentType]:
            if inner is not None:
                for i, ct in zip(pending, inner()):
                    ctypes[i] = ct
            return ctypes

        return resolve, dispatched

    def _feature_config_for(self, content_type: ContentType, sample_rate: int):
        fc = self.content_manager.get_generation_config(content_type).feature_config
        # the base config's geometry wins (fingerprint.go:180-186)
        return fc.with_(
            window_size=self.config.feature_config.window_size,
            hop_size=self.config.feature_config.hop_size,
            sample_rate=sample_rate,
        )

    def _extractor_for(self, content_type: ContentType, sample_rate: int):
        """(extractor, its feature config) for `content_type`."""
        fc = self._feature_config_for(content_type, sample_rate)
        return self.extractor_factory.create_extractor(content_type, fc), fc

    @staticmethod
    def _extract(extractor, pcm: torch.Tensor, fc, sample_rate: int) -> ExtractedFeatures:
        """One extractor call (JAX `generator.py:254-263`): the extractor's
        `extract_features_from_pcm` where it has one (the speech and music
        programs; sports runs its composition there), else its class
        composition over the `stft` of the PCM at the feature config's
        geometry (mixed)."""
        with EXTRACT:
            if hasattr(extractor, "extract_features_from_pcm"):
                return extractor.extract_features_from_pcm(pcm, sample_rate)
            spectrogram = stft(pcm, fc.window_size, fc.hop_size, fc.window_type, sample_rate)
            return extractor.extract_features(spectrogram, pcm, sample_rate)

    def generate_fingerprint(self, audio: AudioData) -> AudioFingerprint:
        """GenerateFingerprint (fingerprint.go:137-236)."""
        if audio is None or len(audio.pcm) == 0:
            raise ValueError("audio data cannot be empty")
        content_type = self._detect_content_type(audio)
        extractor, fc = self._extractor_for(content_type, audio.sample_rate)
        features = self._extract(extractor, self._as_tensor(audio.pcm), fc, audio.sample_rate)
        fp = self._assemble_fp(audio, content_type, audio.sample_rate, extractor, features)
        fp.features = features
        return fp

    def _assemble_fp(
        self, audio: AudioData, ct: ContentType, sr: int, extractor, features
    ) -> AudioFingerprint:
        """The fingerprint object of one clip; `features` (the clip's or
        its group's) is read for shapes only, and `features=None` on the
        object until the caller attaches them."""
        fp = AudioFingerprint(
            id=generate_id(audio),
            stream_url=audio.metadata.url if audio.metadata else "",
            content_type=ct,
            timestamp=time.time(),
            duration=audio.duration,
            sample_rate=sr,
            hop_size=self.config.feature_config.hop_size,
            channels=audio.channels,
            features=None,
            metadata={},
        )
        self._add_metadata(fp, audio, extractor, features)
        return fp

    def _prepare_batch(self, audios, pcm_matrix=None) -> torch.Tensor:
        """Validate a batch and return it as one [B, N] float32 tensor.

        pcm_matrix: optional pre-stacked [B, N] tensor or array, used as it
        is (no stack). Row i must hold audios[i].pcm, zero-padded to N
        (`fingerprint.batch_audios` buckets a mixed corpus in this form)."""
        sr = audios[0].sample_rate
        n = len(audios[0].pcm)
        for a in audios:
            if a is None or len(a.pcm) == 0:
                raise ValueError("audio data cannot be empty")
            if a.sample_rate != sr:
                raise ValueError(
                    "generate_fingerprints_batch requires same-rate clips; "
                    "group upstream (fingerprint.batch_audios)"
                )
            if pcm_matrix is None and len(a.pcm) != n:
                raise ValueError(
                    "generate_fingerprints_batch requires equal-length clips; group or "
                    "pad upstream (fingerprint.batch_audios buckets a mixed corpus)"
                )
        if pcm_matrix is not None:
            if pcm_matrix.ndim != 2 or pcm_matrix.shape[0] != len(audios) \
                    or any(len(a.pcm) > pcm_matrix.shape[1] for a in audios):
                raise ValueError(
                    f"pcm_matrix shape {tuple(pcm_matrix.shape)} does not cover the "
                    f"batch (need [{len(audios)}, >=max clip len])"
                )
            return self._as_tensor(pcm_matrix)
        if isinstance(audios[0].pcm, torch.Tensor):
            return self._as_tensor(torch.stack([a.pcm for a in audios]))
        return self._as_tensor(np.stack([np.asarray(a.pcm, dtype=np.float32) for a in audios]))

    def generate_fingerprints_batch(
        self, audios, materialize: bool = True, pcm_matrix=None, speculate: bool = True,
    ):
        """Batched GenerateFingerprint for same-rate, equal-length clips.

        The extractor runs once per content-type group on the stacked
        [G, N] tensor (the program `generate_fingerprint` runs, so batch
        == per-clip), with content detection batched into one feature
        pass.

        materialize=True (default): List[AudioFingerprint] with host numpy
        features. materialize=False: a FingerprintBatch whose features
        stay on the device; `.materialize()` gives the list.

        pcm_matrix: optional pre-stacked [B, N] PCM (row i == audios[i].pcm,
        zero-padded) — skips the stack.

        speculate: when the last batch through this generator was all one
        detected type, launch that type's extractor before the detection
        result reaches the host, so the two overlap. If detection
        disagrees, the speculative features are dropped and the normal
        per-group path runs; the result is the same either way.
        """
        if not audios:
            return [] if materialize else FingerprintBatch([], [])
        sr = audios[0].sample_rate
        pcm_all = self._prepare_batch(audios, pcm_matrix)
        with DETECT:
            resolve, dispatched = self._detect_content_types_batch_async(audios, pcm_all)
        spec_ct = self._spec_ct if (speculate and dispatched) else None
        spec_features = None
        if spec_ct is not None:
            ext_s, fc_s = self._extractor_for(spec_ct, sr)
            spec_features = self._extract(ext_s, pcm_all, fc_s, sr)
        ctypes = resolve()
        uniform_ct = ctypes[0] if all(c == ctypes[0] for c in ctypes) else None
        self._spec_ct = uniform_ct
        if spec_ct is not None:
            _log.debug("speculative routing %s: %s", spec_ct.value,
                       "hit" if uniform_ct == spec_ct else "miss")

        fingerprints: List[Optional[AudioFingerprint]] = [None] * len(audios)
        groups: List[Tuple[ContentType, List[int], ExtractedFeatures]] = []
        for ct in dict.fromkeys(ctypes):  # first-seen order
            idxs = [i for i, c in enumerate(ctypes) if c == ct]
            extractor, fc = self._extractor_for(ct, sr)
            if len(idxs) == len(audios):
                if spec_features is not None and ct == spec_ct:
                    features = spec_features  # speculation confirmed
                else:
                    features = self._extract(extractor, pcm_all, fc, sr)
            else:
                pcm = pcm_all[torch.tensor(idxs, device=pcm_all.device)]
                features = self._extract(extractor, pcm, fc, sr)
            groups.append((ct, idxs, features))
            with ASSEMBLE:
                for i in idxs:
                    fingerprints[i] = self._assemble_fp(audios[i], ct, sr, extractor, features)

        batch = FingerprintBatch(fingerprints, groups)
        return batch.materialize() if materialize else batch

    def generate_fingerprints_mixed(self, audios) -> List[AudioFingerprint]:
        """GenerateFingerprint over any corpus — mixed lengths and sample
        rates — in input order: each `batch_audios` bucket runs the
        batched path on its zero-padded [G, N] matrix. Zero padding
        extends a clip's silent tail, so whole-clip scalars see the
        padded length (a reference-side fault the JAX package has too,
        fingerprint/batching.py:13-20). Metadata reflects the original
        clips."""
        from sonido_sonar_tpu_torch.fingerprint.batching import batch_audios

        out: List[Optional[AudioFingerprint]] = [None] * len(audios)
        for bucket in batch_audios(audios):
            fps = self.generate_fingerprints_batch(bucket.audios, pcm_matrix=bucket.pcm_matrix)
            for i, fp in zip(bucket.indices, fps):
                out[i] = fp
        return out

    def _add_metadata(
        self, fp: AudioFingerprint, audio: AudioData, extractor,
        features: Optional[ExtractedFeatures],
    ) -> None:
        """utils.go:30-58. Feature stats read shapes only."""
        fp.metadata["extractor_name"] = extractor.get_name()
        fp.metadata["feature_weights"] = extractor.get_feature_weights()
        fp.metadata["generation_time"] = time.time()
        if audio.metadata is not None:
            fp.metadata["stream_metadata"] = audio.metadata
        stats: Dict[str, Any] = {}
        if features is not None:
            if features.mfcc is not None:
                stats["mfcc_frames"] = int(features.mfcc.shape[-2])
                stats["mfcc_coefficients"] = int(features.mfcc.shape[-1])
            if features.spectral_features is not None:
                stats["spectral_frames"] = int(features.spectral_features.spectral_centroid.shape[-1])
        fp.metadata["feature_stats"] = stats
