"""Content-type detection: metadata heuristics + acoustic classifier
(counterpart of `sonido_sonar_tpu/fingerprint/content_detector.py`).

Reference parity: fingerprint/content_detector.go —
  DetectContentType (:31-69): metadata first (explicit type -> genre
  keywords -> station/URL keywords, :492-626), then acoustic, then the
  configured default;
  acoustic features (:120-152): ZCR, spectral centroid of the first 2048
  samples, energy variance (frame 1024 hop 512), silence ratio (RMS <
  0.01), dynamic range 20log10(max/min |x|), low/high split at F/4,
  harmonic peak-ratio, temporal stability (100 ms frames, 1 - cv);
  additive scores vs threshold 2.0 (:156-221) — all constants verbatim.

The batch path computes the [B, 9] features in one pass of tensor ops on
the PCM's device (`torch.fft.rfft` for the spectrum, as the JAX package
uses XLA's FFT) and classifies on the host with the reference's float
math; the per-clip path (`detect_content_type`) is the host float64
numpy version, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from sonido_sonar_tpu_torch.config.config import ContentAwareConfig, ContentType
from sonido_sonar_tpu_torch.io.audio import AudioData, AudioMetadata, host_pcm
from sonido_sonar_tpu_torch.utils.device import DEFAULT_DEVICE, Device, as_float32
from sonido_sonar_tpu_torch.ops.temporal import framed_sum_hopblocks
from sonido_sonar_tpu_torch.utils.metrics import Span, count_host_sync

# resolve()'s wait for the [K, 9] features on the host (the generator's
# detection wait)
DETECT_WAIT = Span("generator.detect_wait")

_MUSIC_GENRES = [
    "rock", "pop", "jazz", "classical", "hip-hop", "hip hop", "country",
    "electronic", "blues", "reggae", "folk", "metal", "punk", "r&b",
    "soul", "funk", "dance", "techno", "house", "ambient", "indie",
    "alternative", "grunge", "ska", "latin", "world", "gospel",
]
_NEWS_GENRES = [
    "news", "talk", "politics", "current affairs", "public radio",
    "discussion", "interview", "call-in", "spoken word", "commentary",
    "analysis", "reporting", "journalism", "public affairs",
]
_SPORTS_GENRES = [
    "sports", "football", "basketball", "baseball", "soccer", "hockey",
    "tennis", "golf", "racing", "motorsports", "athletics", "cricket",
    "rugby", "boxing", "mma", "sports talk", "sports news",
]
_NEWS_STATIONS = [
    "news", "npr", "bbc", "cnn", "cbc", "abc news", "nbc news",
    "fox news", "public radio", "current affairs", "talk radio",
]
_SPORTS_STATIONS = [
    "sports", "espn", "fox sports", "sports radio", "the fan",
    "sport", "athletic", "game", "stadium",
]
_MUSIC_STATIONS = [
    "fm", "music", "hits", "rock", "pop", "jazz", "country",
    "classic", "radio", "mix", "beat", "sound", "groove",
]


@dataclass
class AcousticFeatures:
    """AcousticFeatures (content_detector.go:103-118)."""

    zero_crossing_rate: float = 0.0
    spectral_centroid: float = 0.0
    energy_variance: float = 0.0
    silence_ratio: float = 0.0
    harmonic_ratio: float = 0.0
    low_freq_energy: float = 0.0
    high_freq_energy: float = 0.0
    dynamic_range: float = 0.0
    temporal_stability: float = 0.0
    classification_confidence: float = 0.0


def infer_from_genre(genre: str) -> ContentType:
    """content_detector.go:490-540."""
    g = genre.lower().strip()
    for kw in _MUSIC_GENRES:
        if kw in g:
            return ContentType.MUSIC
    for kw in _NEWS_GENRES:
        if kw in g:
            return ContentType.NEWS
    for kw in _SPORTS_GENRES:
        if kw in g:
            return ContentType.SPORTS
    if "talk" in g and "sports" not in g:
        return ContentType.TALK
    return ContentType.UNKNOWN


def infer_from_station(station: str, url: str) -> ContentType:
    """content_detector.go:543-590."""
    combined = f"{station.lower().strip()} {url.lower()}"
    for kw in _NEWS_STATIONS:
        if kw in combined:
            return ContentType.NEWS
    for kw in _SPORTS_STATIONS:
        if kw in combined:
            return ContentType.SPORTS
    for kw in _MUSIC_STATIONS:
        if kw in combined:
            return ContentType.MUSIC
    if "talk" in combined and "sports" not in combined:
        return ContentType.TALK
    return ContentType.UNKNOWN


def parse_content_type(content_type: str) -> ContentType:
    """content_detector.go:613-626."""
    ct = content_type.lower()
    if ct in ("music", "audio/music"):
        return ContentType.MUSIC
    if ct in ("news", "talk", "spoken"):
        return ContentType.NEWS
    if ct == "sports":
        return ContentType.SPORTS
    return ContentType.UNKNOWN


def detect_from_metadata(metadata: Optional[AudioMetadata]) -> ContentType:
    """content_detector.go:593-610."""
    if metadata is None:
        return ContentType.UNKNOWN
    explicit = metadata.extra.get("content_type", "")
    if explicit:
        return parse_content_type(explicit)
    if metadata.genre:
        return infer_from_genre(metadata.genre)
    return infer_from_station(metadata.station, metadata.url)


def batched_acoustic_features(pcm: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """[B, N] PCM -> [B, 9] float32 acoustic classifier features on the
    PCM's device, in the order zcr, centroid, energy_variance,
    silence_ratio, dynamic_range, low_ratio, high_ratio, harmonic_ratio,
    temporal_stability — the host float64 math (content_detector.go:
    120-152) in float32 tensor ops."""
    x = pcm.to(torch.float32)
    b, n = x.shape
    dev = x.device
    zero = torch.zeros((b,), dtype=torch.float32, device=dev)

    # ZCR over the whole signal (:225-237)
    if n > 1:
        nonneg = x >= 0
        zcr = torch.mean((nonneg[:, 1:] != nonneg[:, :-1]).to(torch.float32), dim=-1)
    else:
        zcr = zero

    # |rFFT| of the first 2048 samples (quirk #7 done sanely)
    spec = torch.abs(torch.fft.rfft(x[:, : min(2048, n)], dim=-1))
    f = spec.shape[-1]
    freqs = torch.arange(f, dtype=torch.float32, device=dev) * (sample_rate / (f * 2.0))
    m_sum = torch.sum(spec, dim=-1)
    centroid = torch.where(
        m_sum > 0, torch.sum(spec * freqs, dim=-1) / torch.clamp_min(m_sum, 1e-12), 0.0
    )

    # energy variance: frame 1024 hop 512 mean-square energies ->
    # population variance (:258-293)
    energy_var = zero
    if n >= 2048:
        n_fr = -(-(n - 1024) // 512)  # len(range(0, n - 1024, 512))
        if n_fr > 1:
            e = framed_sum_hopblocks(x * x, 1024, 512, n_fr) / 1024
            energy_var = torch.var(e, dim=-1, correction=0)

    # silence ratio: RMS < 0.01 per non-overlapping 1024 frame (:296-320)
    t_sil = n // 1024
    silence = zero
    if t_sil > 0:
        segs = x[:, : t_sil * 1024].reshape(b, t_sil, 1024)
        rms = torch.sqrt(torch.mean(segs * segs, dim=-1))
        silence = torch.mean((rms < 0.01).to(torch.float32), dim=-1)

    # dynamic range 20log10(max|x| / min nonzero |x|) (:322-345)
    a = torch.abs(x)
    mx = torch.amax(a, dim=-1)
    mn = torch.amin(torch.where(a > 1e-10, a, float("inf")), dim=-1)
    dyn = torch.where(
        torch.isfinite(mn) & (mx > 0),
        20.0 * torch.log10(torch.clamp_min(mx, 1e-12) / torch.clamp_min(mn, 1e-12)),
        0.0,
    )

    # low/high split at F/4 (:348-371)
    p = spec * spec
    low = torch.sum(p[:, : f // 4], dim=-1)
    high = torch.sum(p[:, f // 4:], dim=-1)
    tot = low + high
    low_ratio = torch.where(tot > 0, low / torch.clamp_min(tot, 1e-12), 0.0)
    high_ratio = torch.where(tot > 0, high / torch.clamp_min(tot, 1e-12), 0.0)

    # harmonic peak-ratio (:374-407): +-1/+-2 local maxima, the first
    # peak is the fundamental, count near-integer-ratio later peaks
    harmonic = zero
    if f >= 10:
        core = spec[:, 2: f - 2]
        mask = (
            (core > spec[:, 1: f - 3]) & (core > spec[:, 3: f - 1])
            & (core > spec[:, 0: f - 4]) & (core > spec[:, 4:f])
        )
        idx = torch.arange(2, f - 2, dtype=torch.float32, device=dev)
        npk = torch.sum(mask, dim=-1)
        f0 = torch.argmax(mask.to(torch.uint8), dim=-1).to(torch.float32) + 2.0
        ratio = idx[None, :] / torch.clamp_min(f0[:, None], 1.0)
        near = torch.abs(ratio - torch.round(ratio)) < 0.1
        harm = torch.sum(mask & near & (idx[None, :] > f0[:, None]), dim=-1).to(torch.float32)
        harmonic = torch.where(
            npk >= 2, harm / torch.clamp_min(npk - 1, 1).to(torch.float32), 0.0
        )

    # temporal stability: non-overlapping 100 ms frame energies -> 1 - cv
    # (:410-450)
    frame_s = sample_rate // 10
    stability = zero
    if n >= frame_s * 3:
        count = -(-(n - frame_s) // frame_s)  # len(range(0, n - f, f))
        t_full = n // frame_s
        blocks = torch.sum((x[:, : t_full * frame_s] ** 2).reshape(b, t_full, frame_s), dim=-1)
        e = blocks[:, :count]
        mean = torch.mean(e, dim=-1)
        cv = torch.where(
            mean > 0,
            torch.sqrt(torch.var(e, dim=-1, correction=0)) / torch.clamp_min(mean, 1e-20),
            float("inf"),
        )
        stability = torch.where(
            (mean > 0) & (count > 1), torch.clamp_min(1.0 - cv, 0.0), 0.0
        )

    return torch.stack(
        [zcr, centroid, energy_var, silence, dyn, low_ratio, high_ratio, harmonic, stability],
        dim=-1,
    )


# JAX's name for the same function (fingerprint/content_detector.py:133)
batched_acoustic_features_device = batched_acoustic_features


class ContentDetector:
    """ContentDetector (content_detector.go:19-118). The batch path's
    feature pass runs on `device` for clips given as numpy (the card
    unless the caller asks for the CPU)."""

    def __init__(self, config: Optional[ContentAwareConfig] = None,
                 device: Device = DEFAULT_DEVICE):
        self.config = config or ContentAwareConfig()
        self.device = torch.device(device)

    def detect_content_type(self, audio: AudioData) -> ContentType:
        """DetectContentType (content_detector.go:31-69)."""
        meta_type = detect_from_metadata(audio.metadata)
        if meta_type != ContentType.UNKNOWN:
            return meta_type
        if self.config.enable_content_detection and len(audio.pcm) > 0:
            acoustic = self.detect_from_audio(audio.pcm, audio.sample_rate)
            if acoustic != ContentType.UNKNOWN:
                return acoustic
        return self.config.default_content_type

    def detect_from_audio(self, pcm, sample_rate: int) -> ContentType:
        """DetectFromAudio (content_detector.go:72-103)."""
        if len(pcm) == 0:
            return ContentType.UNKNOWN
        return self.classify_from_features(self.extract_acoustic_features(pcm, sample_rate))

    def detect_batch(self, audios, pcm_device: Optional[torch.Tensor] = None) -> list:
        """detect_content_type over a batch: the metadata cascade per clip
        on the host, then `batched_acoustic_features` for every clip still
        UNKNOWN and one [K, 9] fetch feeding the host classifier.

        pcm_device: optional [B, N] tensor of ALL clips; when given the
        features are computed from it (on its device) instead of a stack
        of the clips' PCM."""
        resolve, _ = self.detect_batch_async(audios, pcm_device)
        return resolve()

    def detect_batch_async(self, audios, pcm_device: Optional[torch.Tensor] = None):
        """Split detect_batch: launch the feature pass and the [K, 9]
        device-to-host copy now, classify in the returned `resolve()`.
        Returns (resolve, dispatched); `dispatched` says whether a feature
        pass was launched (False when every clip resolved from metadata or
        detection is off). On a CUDA device the copy goes to pinned memory
        behind an event, so work the caller launches after this call
        (the generator's speculative extractor) does not delay it, and
        resolve() waits for the copy alone."""
        out = []
        need = []
        for i, a in enumerate(audios):
            t = detect_from_metadata(a.metadata)
            out.append(t)
            if t == ContentType.UNKNOWN and self.config.enable_content_detection and len(a.pcm) > 0:
                need.append(i)
        host = None
        ready = None
        rows = []
        if need:
            if pcm_device is None:
                pcm_device = as_float32(
                    np.stack([host_pcm(audios[i].pcm) for i in need]), self.device
                )
                rows = list(range(len(need)))
            else:
                rows = need
            feats = batched_acoustic_features(pcm_device, audios[need[0]].sample_rate)
            if feats.is_cuda:
                host = torch.empty(feats.shape, dtype=feats.dtype, pin_memory=True)
                host.copy_(feats, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record()
            else:
                host = feats

        def resolve() -> list:
            if host is not None:
                with DETECT_WAIT:
                    count_host_sync()   # the [K, 9] copy to the host
                    if ready is not None:
                        ready.synchronize()
                feats = host.numpy()
                for row, i in zip(rows, need):
                    z = feats[row]
                    out[i] = self.classify_from_features(AcousticFeatures(
                        zero_crossing_rate=float(z[0]),
                        spectral_centroid=float(z[1]),
                        energy_variance=float(z[2]),
                        silence_ratio=float(z[3]),
                        dynamic_range=float(z[4]),
                        low_freq_energy=float(z[5]),
                        high_freq_energy=float(z[6]),
                        harmonic_ratio=float(z[7]),
                        temporal_stability=float(z[8]),
                    ))
            for i, t in enumerate(out):
                if t == ContentType.UNKNOWN:
                    out[i] = self.config.default_content_type
            return out

        return resolve, host is not None

    # ------------------------------------------------------------------
    def extract_acoustic_features(self, pcm, sample_rate: int) -> AcousticFeatures:
        """extractAcousticFeatures (content_detector.go:120-152) in host
        float64 numpy (the first 2048 samples for the spectrum, frame
        loops over the PCM)."""
        x = host_pcm(pcm).astype(np.float64)
        f = AcousticFeatures()

        # ZCR over the whole signal (:225-237)
        if len(x) > 1:
            nonneg = x >= 0
            f.zero_crossing_rate = float(
                np.mean(nonneg[1:] != nonneg[:-1])
            )

        # spectrum of the first 2048 samples — rFFT instead of the O(N^2)
        # DFT (quirk #7); |rfft| equals the reference's magnitude output
        w = min(2048, len(x))
        spectrum = np.abs(np.fft.rfft(x[:w]))

        # spectral centroid with freq = i * sr / (len(spectrum) * 2)
        # (:240-255 — note the reference's own resolution convention)
        freqs = np.arange(len(spectrum)) * sample_rate / (len(spectrum) * 2.0)
        mag_sum = spectrum.sum()
        f.spectral_centroid = float(
            (freqs * spectrum).sum() / mag_sum if mag_sum > 0 else 0.0
        )

        f.energy_variance = self._energy_variance(x)
        f.silence_ratio = self._silence_ratio(x)
        f.dynamic_range = self._dynamic_range(x)
        f.low_freq_energy, f.high_freq_energy = self._freq_energy_ratio(spectrum)
        f.harmonic_ratio = self._harmonic_ratio(spectrum)
        f.temporal_stability = self._temporal_stability(x, sample_rate)
        return f

    @staticmethod
    def _energy_variance(x: np.ndarray) -> float:
        """frame 1024 hop 512 mean-square energies -> population variance
        (:258-293). Vectorized via cumsum."""
        frame = 1024
        if len(x) < frame * 2:
            return 0.0
        csum = np.concatenate([[0.0], np.cumsum(x * x)])
        starts = np.arange(0, len(x) - frame, frame // 2)
        energies = (csum[starts + frame] - csum[starts]) / frame
        if len(energies) <= 1:
            return 0.0
        return float(np.var(energies))

    @staticmethod
    def _silence_ratio(x: np.ndarray) -> float:
        """RMS < 0.01 per 1024 frame (:296-320). Vectorized."""
        frame = 1024
        t = len(x) // frame
        if t == 0:
            return 0.0
        segs = x[: t * frame].reshape(t, frame)
        rms = np.sqrt((segs * segs).mean(axis=1))
        return float((rms < 0.01).mean())

    @staticmethod
    def _dynamic_range(x: np.ndarray) -> float:
        """20log10(max|x| / min nonzero |x|) (:322-345)."""
        a = np.abs(x)
        max_v = a.max() if len(a) else 0.0
        nz = a[a > 1e-10]
        if len(nz) == 0 or max_v == 0:
            return 0.0
        return float(20.0 * np.log10(max_v / nz.min()))

    @staticmethod
    def _freq_energy_ratio(spectrum: np.ndarray):
        """low/high split at len/4 (:348-371)."""
        split = len(spectrum) // 4
        low = float((spectrum[:split] ** 2).sum())
        high = float((spectrum[split:] ** 2).sum())
        total = low + high
        if total == 0:
            return 0.0, 0.0
        return low / total, high / total

    @staticmethod
    def _harmonic_ratio(spectrum: np.ndarray) -> float:
        """peak-ratio harmonicity (:374-407)."""
        if len(spectrum) < 10:
            return 0.0
        s = spectrum
        peaks = [
            i
            for i in range(2, len(s) - 2)
            if s[i] > s[i - 1] and s[i] > s[i + 1] and s[i] > s[i - 2] and s[i] > s[i + 2]
        ]
        if len(peaks) < 2:
            return 0.0
        fundamental = peaks[0]
        harmonic = sum(
            1
            for p in peaks[1:]
            if abs(p / fundamental - round(p / fundamental)) < 0.1
        )
        return harmonic / (len(peaks) - 1)

    @staticmethod
    def _temporal_stability(x: np.ndarray, sample_rate: int) -> float:
        """100 ms frame energies -> 1 - cv (:410-450). Vectorized."""
        frame = sample_rate // 10
        if len(x) < frame * 3:
            return 0.0
        t = (len(x) - frame) // frame + ((len(x) - frame) % frame > 0)
        csum = np.concatenate([[0.0], np.cumsum(x * x)])
        starts = np.arange(0, len(x) - frame, frame)
        energies = csum[starts + frame] - csum[starts]
        if len(energies) <= 1:
            return 0.0
        mean = float(np.mean(energies))
        if mean == 0:
            return 0.0
        cv = float(np.std(energies)) / mean
        return max(0.0, 1.0 - cv)

    # ------------------------------------------------------------------
    def classify_from_features(self, f: AcousticFeatures) -> ContentType:
        """classifyFromFeatures (content_detector.go:156-221), constants
        verbatim."""
        scores = {}
        music = 0.0
        if f.zero_crossing_rate < 0.1:
            music += 2.0
        if f.harmonic_ratio > 0.3:
            music += 2.0
        if f.temporal_stability > 0.5:
            music += 1.0
        if f.dynamic_range > 20:
            music += 1.0
        scores[ContentType.MUSIC] = music

        speech = 0.0
        if 0.05 < f.zero_crossing_rate < 0.3:
            speech += 2.0
        if 800 < f.spectral_centroid < 3000:
            speech += 2.0
        if f.harmonic_ratio < 0.2:
            speech += 1.0
        if 0.1 < f.silence_ratio < 0.4:
            speech += 1.0
        scores[ContentType.NEWS] = speech
        scores[ContentType.TALK] = speech * 0.9

        sports = 0.0
        if f.energy_variance > 0.3:
            sports += 2.0
        if f.dynamic_range > 30:
            sports += 1.5
        if f.temporal_stability < 0.4:
            sports += 1.0
        scores[ContentType.SPORTS] = sports

        best_type = ContentType.UNKNOWN
        best_score = self.config.auto_detect_threshold
        for ct, score in scores.items():
            if score > best_score:
                best_score = score
                best_type = ct
        f.classification_confidence = best_score / 6.0
        return best_type
