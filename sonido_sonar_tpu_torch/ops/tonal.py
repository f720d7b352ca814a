"""Tonal analysis: key estimation, chord detection, HNR, inharmonicity,
and the multi-method pitch-detection facade (counterpart of
`sonido_sonar_tpu/ops/tonal.py`).

Reference parity: algorithms/tonal/*.go —
  key_estimation.go: 12-bin chroma x 24 key correlation against 7
    profile sets (Krumhansl-Schmuckler, Temperley, Shaath, EDMA, Bgate,
    Diatonic, TonicTriad — constants verbatim from :404-463), sequence
    mode with temporal stability + modulation detection (:250-273);
  chord_detection.go: template matching over chord qualities and
    inversions, candidate ranking, progression analyzer (:16-247, 1109);
  harmonic_ratio.go: HNR via harmonic-peaks-vs-noise-floor, ACF, HPS,
    comb, spectral methods; voicing decision; temporal tracking
    (:101-205, 297-1080);
  inharmonicity.go: partial deviation vs ideal harmonics (:15-200);
  pitch_detection.go: method facade (YIN, ACF, NSDF/MPM, HPS, cepstrum,
    spectral peaks, zero-crossing + hybrids :730-741), octave
    correction, median filtering, vibrato analysis (:767-1116).

Scores and correlations are computed on the device; the key and chord
rankings run on the host with `np.argsort(...)[::-1]` over the fetched
scores, as in the JAX package, so equal scores rank alike. A chord or
key sequence takes one device product for all its frames or windows.
Everything here is plain PyTorch on every device: the JAX package
computes it as XLA (its YIN over frames is `ops/pitch.yin_pitch`, not
the Pallas K2). The classes take `device` (the card by default): a
tensor stays on its own device, numpy input goes to `device`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sonido_sonar_tpu_torch.ops.chroma import CHROMA_LABELS
from sonido_sonar_tpu_torch.ops.framing import frame_signal
from sonido_sonar_tpu_torch.ops.harmonic import detect_spectral_peaks, estimate_f0_hps
from sonido_sonar_tpu_torch.ops.pitch import PitchParams, acf_pitch, median_filter_pitch, yin_pitch
from sonido_sonar_tpu_torch.ops.tables import device_table
from sonido_sonar_tpu_torch.utils.device import DEFAULT_DEVICE, Device, as_float32

_EPS = 1e-10
_INF = float("inf")


def _host32(x) -> np.ndarray:
    """A tensor or array-like as a float32 numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _rdiv(numerator: float, t: torch.Tensor) -> torch.Tensor:
    """numerator / t as one float32 division, as JAX divides a Python
    number by an array (torch's `number / tensor` multiplies by the
    reciprocal, which can round differently)."""
    t = t.to(torch.float32)
    return torch.full_like(t, float(numerator)) / t


# ---------------------------------------------------------------------
# Key estimation (key_estimation.go)
# ---------------------------------------------------------------------

# verbatim profile constants (key_estimation.go:404-463)
KEY_PROFILES: Dict[str, Dict[str, np.ndarray]] = {
    "krumhansl": {
        "major": np.array([6.35, 2.23, 3.48, 2.33, 4.38, 4.09, 2.52, 5.19, 2.39, 3.66, 2.29, 2.88]),
        "minor": np.array([6.33, 2.68, 3.52, 5.38, 2.60, 3.53, 2.54, 4.75, 3.98, 2.69, 3.34, 3.17]),
    },
    "temperley": {
        "major": np.array([5.0, 2.0, 3.5, 2.0, 4.5, 4.0, 2.0, 4.5, 2.0, 3.5, 1.5, 4.0]),
        "minor": np.array([5.0, 2.0, 3.5, 4.5, 2.0, 4.0, 2.0, 4.5, 3.5, 2.0, 1.5, 4.0]),
    },
    "shaath": {
        "major": np.array([6.6, 2.0, 3.5, 2.3, 4.6, 4.0, 2.5, 5.2, 2.4, 3.7, 2.3, 3.4]),
        "minor": np.array([6.5, 2.7, 3.5, 5.4, 2.6, 3.5, 2.5, 4.7, 4.0, 2.7, 3.4, 3.2]),
    },
    "edma": {
        "major": np.array([17.7661, 0.145624, 14.9265, 0.160186, 19.8049, 11.3587, 0.291248, 22.062, 0.145624, 8.15494, 0.232998, 4.95122]),
        "minor": np.array([18.2648, 0.737619, 14.0499, 16.8599, 0.702494, 14.4362, 0.702494, 18.6161, 4.56621, 1.93186, 7.37619, 1.75623]),
    },
    "bgate": {
        "major": np.array([16.8, 0.86, 12.95, 1.41, 13.49, 11.93, 1.25, 20.28, 1.80, 8.04, 0.62, 10.57]),
        "minor": np.array([18.16, 0.69, 12.99, 13.34, 1.07, 11.15, 1.38, 21.07, 7.49, 1.53, 6.24, 1.61]),
    },
    "diatonic": {
        "major": np.array([5.0, 0.0, 3.0, 0.0, 4.0, 3.5, 0.0, 4.5, 0.0, 3.0, 0.0, 2.0]),
        "minor": np.array([5.0, 0.0, 3.0, 3.5, 0.0, 3.5, 0.0, 4.5, 3.0, 0.0, 2.0, 0.0]),
    },
    "tonic_triad": {
        "major": np.array([5.0, 0.0, 0.0, 0.0, 3.0, 0.0, 0.0, 4.0, 0.0, 0.0, 0.0, 0.0]),
        "minor": np.array([5.0, 0.0, 0.0, 3.0, 0.0, 0.0, 0.0, 4.0, 0.0, 0.0, 0.0, 0.0]),
    },
}


@dataclass
class KeyEstimationResult:
    """KeyEstimationResult (key_estimation.go:130-160)."""

    key: str
    mode: str  # "major" | "minor"
    strength: float
    confidence: float  # first-vs-second margin
    all_correlations: np.ndarray  # [24]
    profile: str = "krumhansl"
    stability: float = 0.0
    modulations: List[dict] = field(default_factory=list)


def _profile_matrix(profile: str) -> np.ndarray:
    """[24, 12]: rows 0-11 major roots, 12-23 minor roots."""
    p = KEY_PROFILES[profile]
    rows = [np.roll(p["major"], r) for r in range(12)]
    rows += [np.roll(p["minor"], r) for r in range(12)]
    return np.stack(rows).astype(np.float32)


def _pearson_rows(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Pearson correlation of each row of v [R, 12] with each row of
    m [24, 12] -> [R, 24]."""
    vm = v - torch.mean(v, dim=-1, keepdim=True)
    mm = m - torch.mean(m, dim=-1, keepdim=True)
    num = torch.sum(vm[:, None, :] * mm, dim=-1)
    den = torch.sqrt(torch.sum(vm * vm, dim=-1)[:, None] * torch.sum(mm * mm, dim=-1))
    return torch.where(den > _EPS, num / torch.clamp_min(den, _EPS), 0.0)


class KeyEstimator:
    """KeyEstimator (key_estimation.go:13-124)."""

    def __init__(self, profile: str = "krumhansl", device: Device = DEFAULT_DEVICE):
        if profile not in KEY_PROFILES:
            raise ValueError(f"unknown key profile {profile}")
        self.profile = profile
        self.device = torch.device(device)
        self._matrix = device_table(_profile_matrix, (profile,), self.device)

    def _correlations(self, rows: np.ndarray) -> np.ndarray:
        """[R, 12] float32 chroma rows -> [R, 24] correlations, one device pass."""
        v = torch.from_numpy(np.ascontiguousarray(rows)).to(self.device)
        return _pearson_rows(v, self._matrix).cpu().numpy()

    def _result(self, corr: np.ndarray) -> KeyEstimationResult:
        order = np.argsort(corr)[::-1]
        best = int(order[0])
        return KeyEstimationResult(
            key=CHROMA_LABELS[best % 12],
            mode="major" if best < 12 else "minor",
            strength=float(corr[best]),
            confidence=float(corr[order[0]] - corr[order[1]]),
            all_correlations=corr,
            profile=self.profile,
        )

    def estimate_key(self, chroma_vector) -> KeyEstimationResult:
        """EstimateKey (key_estimation.go:196-233): Pearson correlation
        against all 24 shifted profiles."""
        return self._result(self._correlations(_host32(chroma_vector)[None])[0])

    def estimate_key_sequence(self, chroma_seq) -> KeyEstimationResult:
        """EstimateKeySequence (key_estimation.go:250-273): average
        chroma + stability + modulation detection. The whole sequence and
        its windows take one device pass."""
        seq = _host32(chroma_seq)  # [T, 12]
        win = max(len(seq) // 8, 4)
        subs = [seq[start: start + win].mean(axis=0) for start in range(0, max(len(seq) - win, 1), win)]
        corr = self._correlations(np.stack([seq.mean(axis=0)] + subs))
        result = self._result(corr[0])
        # temporal stability: fraction of windows agreeing with the key
        keys = [self._result(c) for c in corr[1:]]
        agree = sum(1 for k in keys if (k.key, k.mode) == (result.key, result.mode))
        result.stability = agree / max(len(keys), 1)
        # modulation detection: windowed key changes (:260-270)
        if len(seq) > 10:
            prev = None
            for i, k in enumerate(keys):
                cur = (k.key, k.mode)
                if prev is not None and cur != prev and k.confidence > 0.05:
                    result.modulations.append(
                        {"window": i, "from": prev, "to": cur, "strength": k.strength}
                    )
                prev = cur
        return result


# ---------------------------------------------------------------------
# Chord detection (chord_detection.go)
# ---------------------------------------------------------------------

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


@dataclass
class ChordCandidate:
    root: str
    quality: str
    score: float
    inversion: int = 0


@dataclass
class ChordDetectionResult:
    chord: str
    root: str
    quality: str
    confidence: float
    candidates: List[ChordCandidate] = field(default_factory=list)


def chord_template_matrix() -> Tuple[np.ndarray, List[Tuple[str, str]]]:
    """([n_chords, 12] float32 unit-norm templates, [(root, quality)]
    labels): qualities in table order, roots C..B."""
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


class ChordDetector:
    """ChordDetector (chord_detection.go:16-247): cosine template match
    over qualities x 12 roots."""

    def __init__(self, qualities: Optional[List[str]] = None, device: Device = DEFAULT_DEVICE):
        self.device = torch.device(device)
        self._matrix = device_table(chord_matrix, (), self.device)
        self._labels = CHORD_LABELS
        self._allowed = set(qualities) if qualities else None

    def _scores(self, unit_rows: np.ndarray) -> np.ndarray:
        """[R, 12] unit chroma rows -> [R, n_chords] cosines in one device
        pass. The 12 products are summed in a fixed order, so a frame's
        scores do not depend on the other rows (a BLAS product's order
        can): detect_sequence gives detect_chord's results bit for bit."""
        v = torch.from_numpy(np.ascontiguousarray(unit_rows)).to(self.device)
        m = self._matrix
        sims = v[:, :1] * m[:, 0]
        for k in range(1, m.shape[1]):
            sims = sims + v[:, k: k + 1] * m[:, k]
        return sims.cpu().numpy()

    def _rank(self, sims: np.ndarray, top_k: int) -> ChordDetectionResult:
        if self._allowed is not None:
            for i, (_, q) in enumerate(self._labels):
                if q not in self._allowed:
                    sims[i] = -np.inf
        order = np.argsort(sims)[::-1]
        cands = [
            ChordCandidate(self._labels[i][0], self._labels[i][1], float(sims[i]))
            for i in order[:top_k]
        ]
        best = cands[0]
        margin = float(sims[order[0]] - sims[order[1]]) if len(order) > 1 else 1.0
        return ChordDetectionResult(
            chord=f"{best.root}{'' if best.quality == 'major' else ':' + best.quality}",
            root=best.root,
            quality=best.quality,
            confidence=min(1.0, max(0.0, best.score * 0.5 + margin * 2.0)),
            candidates=cands,
        )

    def detect_chord(self, chroma_vector, top_k: int = 5) -> ChordDetectionResult:
        v = _host32(chroma_vector)
        nv = np.linalg.norm(v)
        if nv < _EPS:
            return ChordDetectionResult("N", "N", "none", 0.0)
        return self._rank(self._scores((v / nv)[None])[0], top_k)

    def detect_sequence(self, chroma_seq) -> List[ChordDetectionResult]:
        """detect_chord on every frame of [T, 12]: the frames' scores in
        one device product, each frame ranked on the host."""
        seq = _host32(chroma_seq)
        norms = [np.linalg.norm(v) for v in seq]
        live = [i for i, nv in enumerate(norms) if nv >= _EPS]
        sims = self._scores(np.stack([seq[i] / norms[i] for i in live])) if live else None
        out = [ChordDetectionResult("N", "N", "none", 0.0)] * len(seq)
        for row, i in enumerate(live):
            out[i] = self._rank(sims[row], 5)
        return out


class ChordProgressionAnalyzer:
    """ChordProgressionAnalyzer (chord_detection.go:1109-...): smoothing
    + transition statistics."""

    def __init__(self, detector: Optional[ChordDetector] = None, min_run: int = 2,
                 device: Device = DEFAULT_DEVICE):
        self.detector = detector or ChordDetector(device=device)
        self.min_run = min_run

    def analyze(self, chroma_seq) -> dict:
        chords = [r.chord for r in self.detector.detect_sequence(chroma_seq)]
        # run-length smoothing: drop runs shorter than min_run
        smoothed: List[str] = []
        i = 0
        while i < len(chords):
            j = i
            while j < len(chords) and chords[j] == chords[i]:
                j += 1
            if j - i >= self.min_run or not smoothed:
                smoothed.extend(chords[i:j])
            else:
                smoothed.extend([smoothed[-1]] * (j - i))
            i = j
        # progression = deduped sequence
        progression = [smoothed[0]] if smoothed else []
        for c in smoothed[1:]:
            if c != progression[-1]:
                progression.append(c)
        changes = len(progression) - 1
        return {
            "chords": smoothed,
            "progression": progression,
            "num_changes": changes,
            "change_rate": changes / max(len(smoothed), 1),
            "unique_chords": len(set(smoothed)),
        }


# ---------------------------------------------------------------------
# Harmonic ratio / HNR (harmonic_ratio.go)
# ---------------------------------------------------------------------

@dataclass
class HarmonicRatioResult:
    """HarmonicRatioResult fields used downstream."""

    harmonic_ratio: torch.Tensor   # HNR in dB
    voicing: torch.Tensor          # bool
    f0: torch.Tensor


def _hanning(w: int) -> np.ndarray:
    return np.hanning(w)


class HarmonicRatioAnalyzer:
    """HarmonicRatioAnalyzer.AnalyzeFrame (harmonic_ratio.go:101-205).

    Methods: 'acf' (normalized autocorrelation at the period — the live
    default), 'yin' (1 - cmndf), 'hnr' / 'comb' (the harmonic-mask
    energy split of the frame spectra); `analyze_spectrum` is the
    spectral method (harmonic peaks vs the local noise floor).
    """

    def __init__(self, sample_rate: int, method: str = "acf",
                 min_f0: float = 50.0, max_f0: float = 1000.0,
                 voicing_threshold: float = 0.45, device: Device = DEFAULT_DEVICE):
        self.sample_rate = sample_rate
        self.method = method
        self.params = PitchParams(sample_rate=sample_rate, min_freq=min_f0, max_freq=max_f0)
        self.voicing_threshold = voicing_threshold
        self.device = device

    def analyze_frames(self, frames) -> HarmonicRatioResult:
        """frames: [..., W] -> HNR dB per frame."""
        from sonido_sonar_tpu_torch.ops.speech import hnr_acf

        frames = as_float32(frames, self.device)
        if self.method == "acf":
            pitch, conf = acf_pitch(frames, self.params)
            hnr = hnr_acf(frames, self.sample_rate, torch.clamp_min(pitch, 1.0))
            hnr = torch.where(pitch > 0, hnr, 0.0)
            return HarmonicRatioResult(hnr, conf > self.voicing_threshold, pitch)
        if self.method == "yin":
            pitch, conf, voicing = yin_pitch(frames, self.params)
            r = torch.clamp(conf, _EPS, 1.0 - 1e-6)
            hnr = torch.where(pitch > 0, 10.0 * torch.log10(r / (1.0 - r)), 0.0)
            return HarmonicRatioResult(hnr, voicing > self.voicing_threshold, pitch)
        if self.method in ("hnr", "comb"):
            # analyzeHNR's harmonic-mask energy split on the frame
            # spectra; the reference's comb method falls back to it
            # (harmonic_ratio.go:456-461)
            w = frames.shape[-1]
            window = device_table(_hanning, (w,), frames.device)
            mag = torch.abs(torch.fft.rfft(frames * window, dim=-1))
            pitch, conf = acf_pitch(frames, self.params)
            hnr = self.analyze_spectrum_mask(mag, w, f0=pitch)
            return HarmonicRatioResult(hnr, conf > self.voicing_threshold, pitch)
        raise ValueError(f"unknown HNR method {self.method}")

    def analyze_spectrum(
        self, magnitude, window_size: int, num_harmonics: int = 8,
        noise_estimation: str = "percentile", noise_floor_percentile: float = 0.1,
        noise_floor_smoothing: int = 10,
    ) -> torch.Tensor:
        """Spectral-method HNR: energy at harmonic bins of the HPS f0 vs
        the LOCAL-window noise floor (harmonic_ratio.go:632-705),
        [..., F] -> dB.

        noise_estimation selects the reference's estimator: "percentile"
        (NoiseFloorPercentile=0.1 default), "median", "minimum" — a
        20-bin sliding window over the magnitude spectrum, smoothed with
        a 10-bin moving average."""
        magnitude = as_float32(magnitude, self.device)
        f0 = estimate_f0_hps(magnitude, self.sample_rate, window_size,
                             self.params.min_freq, self.params.max_freq)
        n_bins = magnitude.shape[-1]
        freq_res = self.sample_rate / float(window_size)
        power = magnitude * magnitude
        floor = local_noise_floor(
            magnitude, method=noise_estimation, percentile=noise_floor_percentile,
            smoothing_len=noise_floor_smoothing,
        )
        h = torch.arange(1, num_harmonics + 1, dtype=torch.float32, device=magnitude.device)
        bins = torch.clamp((f0[..., None] * h / freq_res).to(torch.int64), 0, n_bins - 1)
        valid = bins > 0
        harm = torch.sum(torch.where(valid, torch.gather(power, -1, bins), 0.0), dim=-1)
        # per-harmonic-bin local floor (squared: floor is in magnitude
        # units, harmonic_ratio.go:802) as the noise estimate at those
        # bins; floor it relative to total power so the ratio stays
        # finite on sparse spectra, and cap HNR at +-60 dB
        floor_power = torch.gather(floor * floor, -1, bins)
        noise_est = torch.sum(torch.where(valid, floor_power, 0.0), dim=-1)
        total_power = torch.sum(power, dim=-1)
        noise = torch.maximum(noise_est, total_power * 1e-6 + _EPS)
        hnr = 10.0 * torch.log10(torch.clamp_min(harm / noise, _EPS))
        return torch.where(harm > 0, torch.clamp(hnr, -60.0, 60.0), 0.0)

    def analyze_spectrum_mask(
        self, magnitude, window_size: int,
        num_harmonics: int = 10, peak_width: int = 3,
        f0: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """analyzeHNR's harmonic-mask energy split
        (harmonic_ratio.go:297-360): bins within +-peak_width of each
        expected harmonic of f0 are 'harmonic', the rest of the
        in-range bins are 'noise'; HNR = 10*log10(Eh/En), 60 dB when no
        noise energy. [..., F] -> dB."""
        magnitude = as_float32(magnitude, self.device)
        n_bins = magnitude.shape[-1]
        freq_res = self.sample_rate / float(window_size)
        if f0 is None:
            f0 = estimate_f0_hps(magnitude, self.sample_rate, window_size,
                                 self.params.min_freq, self.params.max_freq)
        power = magnitude * magnitude
        bins = torch.arange(n_bins, device=magnitude.device)
        h = torch.arange(1, num_harmonics + 1, dtype=torch.float32, device=magnitude.device)
        harm_bins = torch.round(f0[..., None] * h / freq_res)  # [..., H]
        near = torch.abs(bins - harm_bins[..., :, None]) <= peak_width  # [..., H, F]
        in_band = (harm_bins * freq_res <= self.params.max_freq)[..., None]
        mask = torch.any(near & in_band, dim=-2)  # [..., F]
        freqs = bins * freq_res
        in_range = (freqs >= self.params.min_freq) & (freqs <= self.params.max_freq)
        harm = torch.sum(torch.where(mask & in_range, power, 0.0), dim=-1)
        noise = torch.sum(torch.where((~mask) & in_range, power, 0.0), dim=-1)
        hnr = torch.where(
            noise > 0,
            10.0 * torch.log10(torch.clamp_min(harm, _EPS) / torch.clamp_min(noise, _EPS)),
            60.0,
        )
        return torch.where(f0 > 0, hnr, 0.0)

    def spectral_snr(
        self, magnitude, window_size: int,
        noise_estimation: str = "percentile",
        noise_floor_percentile: float = 0.1,
        noise_floor_smoothing: int = 10,
    ) -> torch.Tensor:
        """calculateSNR (harmonic_ratio.go:793-814): total in-range
        signal power vs squared noise floor, dB (60 when floor is 0)."""
        magnitude = as_float32(magnitude, self.device)
        floor = local_noise_floor(
            magnitude, method=noise_estimation, percentile=noise_floor_percentile,
            smoothing_len=noise_floor_smoothing,
        )
        freqs = torch.arange(magnitude.shape[-1], device=magnitude.device) * (
            self.sample_rate / float(window_size))
        in_range = (freqs >= self.params.min_freq) & (freqs <= self.params.max_freq)
        sig = torch.sum(torch.where(in_range, magnitude * magnitude, 0.0), dim=-1)
        noi = torch.sum(torch.where(in_range, floor * floor, 0.0), dim=-1)
        return torch.where(
            noi > 0, 10.0 * torch.log10(torch.clamp_min(sig, _EPS) / torch.clamp_min(noi, _EPS)),
            60.0,
        )


def moving_average(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """common.MovingAverage (common/math.go:140-165): expanding mean
    over the first `window_size` points, trailing-window mean after.
    [..., N] -> [..., N]; window_size <= 0 or > N returns x unchanged."""
    n = x.shape[-1]
    if window_size <= 0 or window_size > n:
        return x
    csum = F.pad(torch.cumsum(x, dim=-1), (1, 0))
    i = torch.arange(n, device=x.device)
    lo = torch.where(i < window_size, 0, i - window_size + 1)
    cnt = torch.where(i < window_size, i + 1, window_size).to(x.dtype)
    return (csum[..., 1:] - csum[..., lo]) / cnt


# gathered window elements one pass of local_noise_floor holds at once:
# the [..., F, 20] gather is 27 GB at [128, 5164, 513]
NOISE_FLOOR_CHUNK_ELEMENTS = 1 << 27


def local_noise_floor(
    magnitude: torch.Tensor,
    method: str = "percentile",
    percentile: float = 0.1,
    smoothing_len: int = 10,
    window_bins: int = 20,
) -> torch.Tensor:
    """Local-window noise-floor estimators (harmonic_ratio.go:650-705):
    per-bin percentile / median (empirical quantile, as common.Percentile
    -> gonum stat.Quantile(Empirical)) / minimum over the [i-W/2, i+W/2)
    window, then common.MovingAverage smoothing. [..., F] -> [..., F].
    The quantile's index is ceil(p nv) - 1, nv the window's valid bins,
    with p nv in float32 as in the JAX package. The windows are gathered
    over chunks of rows (NOISE_FLOOR_CHUNK_ELEMENTS elements each)."""
    f = magnitude.shape[-1]
    dev = magnitude.device
    half = window_bins // 2
    pos = torch.arange(f, device=dev)[:, None] - half + torch.arange(window_bins, device=dev)[None, :]
    valid = (pos >= 0) & (pos < f)                        # [F, W]
    gidx = torch.clamp(pos, 0, f - 1)
    nv = torch.sum(valid, dim=-1)                         # [F]
    if method != "minimum":
        p = 0.5 if method == "median" else percentile
        # gonum Empirical quantile: first sorted value with CDF >= p
        q = torch.ceil(p * nv.to(torch.float32)).to(torch.int64) - 1
        k = torch.minimum(torch.clamp_min(q, 0), nv - 1)

    rows = magnitude.to(torch.float32).reshape(-1, f)
    step = max(NOISE_FLOOR_CHUNK_ELEMENTS // (f * window_bins), 1)
    floors = []
    for r0 in range(0, rows.shape[0], step):
        masked = torch.where(valid, rows[r0: r0 + step][:, gidx], _INF)  # [r, F, W]
        if method == "minimum":
            floors.append(torch.amin(masked, dim=-1))
        else:
            srt = torch.sort(masked, dim=-1).values
            floors.append(torch.gather(srt, -1, k.expand(srt.shape[0], f)[..., None])[..., 0])
    floor = torch.cat(floors).reshape(magnitude.shape)
    if smoothing_len > 1:
        floor = moving_average(floor, smoothing_len)
    return floor


# ---------------------------------------------------------------------
# Inharmonicity (inharmonicity.go)
# ---------------------------------------------------------------------

@dataclass
class InharmonicityResult:
    inharmonicity: torch.Tensor     # mean relative partial deviation
    b_coefficient: torch.Tensor     # stiff-string B estimate
    num_partials: torch.Tensor


def analyze_inharmonicity(
    magnitude: torch.Tensor,
    f0,
    sample_rate: int,
    window_size: int,
    max_partials: int = 10,
) -> InharmonicityResult:
    """InharmonicityAnalyzer.AnalyzeFrame (inharmonicity.go:15-200):
    measure detected-partial deviation from ideal n*f0; fit the
    stiff-string model f_n = n f0 sqrt(1 + B n^2) for B.

    magnitude: [..., F] frames; f0: [...] per frame (on magnitude's
    device).
    """
    magnitude = magnitude.to(torch.float32)
    dev = magnitude.device
    f0 = torch.as_tensor(f0, dtype=torch.float32, device=dev)
    freqs, mags, _ = detect_spectral_peaks(
        magnitude, sample_rate, window_size, max_peaks=max_partials * 2
    )
    freq_res = sample_rate / float(window_size)
    n_bins = magnitude.shape[-1]

    # sub-bin parabolic refinement of each peak frequency: the FFT bin
    # quantization (sr/window) would swamp small partial deviations
    peak_bins = torch.clamp((freqs / freq_res).to(torch.int64), 1, n_bins - 2)
    y0 = torch.gather(magnitude, -1, peak_bins - 1)
    y1 = torch.gather(magnitude, -1, peak_bins)
    y2 = torch.gather(magnitude, -1, peak_bins + 1)
    denom = y0 - 2.0 * y1 + y2
    den_ok = torch.abs(denom) > _EPS
    shift = torch.where(den_ok, 0.5 * (y0 - y2) / torch.where(den_ok, denom, 1.0), 0.0)
    freqs = torch.where(freqs > 0, (peak_bins.to(torch.float32) + shift) * freq_res, 0.0)

    n = torch.arange(1, max_partials + 1, dtype=torch.float32, device=dev)
    ideal = f0[..., None] * n  # [..., P]

    # nearest detected peak to each ideal partial (within 3% of n*f0)
    diff = torch.abs(freqs[..., None, :] - ideal[..., :, None])  # [..., P, K]
    nearest = torch.amin(diff, dim=-1)
    nearest_idx = torch.argmin(diff, dim=-1)
    found_freq = torch.gather(freqs, -1, nearest_idx)
    found_mag = torch.gather(mags, -1, nearest_idx)
    max_mag = torch.amax(mags, dim=-1, keepdim=True)
    tol = 0.03 * torch.clamp_min(f0[..., None], 1.0) * n
    valid = (
        (nearest < tol)
        & (ideal > 0)
        & (found_freq > 0)
        & (found_mag > 0.01 * torch.clamp_min(max_mag, _EPS))
    )

    rel_dev = torch.where(valid, torch.abs(found_freq - ideal) / torch.clamp_min(ideal, _EPS), 0.0)
    num = torch.sum(valid, dim=-1, dtype=torch.int32)
    inh = torch.sum(rel_dev, dim=-1) / torch.clamp_min(num, 1)

    # stiff-string B: (f_n/(n f0))^2 = 1 + B n^2 -> least squares on n^2
    y = torch.where(valid, (found_freq / torch.clamp_min(ideal, _EPS)) ** 2 - 1.0, 0.0)
    x = n * n
    num_b = torch.sum(torch.where(valid, x * y, 0.0), dim=-1)
    den_b = torch.sum(torch.where(valid, x * x, 0.0), dim=-1)
    b = torch.where(den_b > _EPS, num_b / torch.clamp_min(den_b, _EPS), 0.0)
    return InharmonicityResult(inh, b, num)


# ---------------------------------------------------------------------
# Pitch detection facade (pitch_detection.go)
# ---------------------------------------------------------------------

def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True on the last axis (0 if none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def nsdf_pitch(frames: torch.Tensor, params: PitchParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """NSDF / McLeod pitch method (pitch_detection.go:485-551):
    n(tau) = 2 r(tau) / (m(tau)) with m = sum x[j]^2 + x[j+tau]^2; peak
    picking above 0.8 * max."""
    w = frames.shape[-1]
    x = frames.to(torch.float32)
    n_fft = 1
    while n_fft < 2 * w:
        n_fft <<= 1
    f = torch.fft.rfft(x, n=n_fft, dim=-1)
    r = torch.fft.irfft(f * torch.conj(f), n=n_fft, dim=-1)[..., :w]

    csum = F.pad(torch.cumsum(x * x, dim=-1), (1, 0))
    total = csum[..., -1:]
    tau = torch.arange(w, device=x.device)
    # m(tau) = sum_{j<w-tau} x[j]^2 + sum_{j>=tau} x[j]^2
    m = (csum[..., w - tau] - csum[..., 0:1]) + (total - csum[..., tau])
    nsdf = torch.where(m > _EPS, 2.0 * r / torch.clamp_min(m, _EPS), 0.0)

    min_lag = max(int(params.sample_rate / params.max_freq), 2)
    max_lag = min(int(params.sample_rate / params.min_freq) + 1, w - 1)
    lag_valid = (tau >= min_lag) & (tau < max_lag)
    masked = torch.where(lag_valid, nsdf, -_INF)
    peak_max = torch.amax(masked, dim=-1, keepdim=True)
    # first local max above 0.8 * global max
    mid = masked[..., 1:-1]
    local = (mid > masked[..., :-2]) & (mid >= masked[..., 2:]) & (mid > 0.8 * peak_max)
    cand = F.pad(local, (1, 1))
    has = torch.any(cand, dim=-1)
    best = _first_true(cand)
    val = torch.gather(nsdf, -1, best[..., None])[..., 0]
    pitch = torch.where(has, _rdiv(params.sample_rate, torch.clamp_min(best, 1)), 0.0)
    conf = torch.where(has, torch.clamp(val, 0.0, 1.0), 0.0)
    ok = (pitch >= params.min_freq) & (pitch <= params.max_freq)
    return torch.where(ok, pitch, 0.0), torch.where(ok, conf, 0.0)


def cepstrum_pitch(frames: torch.Tensor, params: PitchParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cepstral pitch (pitch_detection.go:623-685): peak of the real
    cepstrum within the period range."""
    w = frames.shape[-1]
    spec = torch.fft.rfft(frames.to(torch.float32), dim=-1)
    log_mag = torch.log(torch.clamp_min(torch.abs(spec), _EPS))
    ceps = torch.fft.irfft(log_mag.to(spec.dtype), n=w, dim=-1)
    min_q = max(int(params.sample_rate / params.max_freq), 2)
    max_q = min(int(params.sample_rate / params.min_freq) + 1, w // 2)
    q = torch.arange(w, device=ceps.device)
    valid = (q >= min_q) & (q < max_q)
    best = torch.argmax(torch.where(valid, ceps, -_INF), dim=-1)
    val = torch.gather(ceps, -1, best[..., None])[..., 0]
    pitch = _rdiv(params.sample_rate, torch.clamp_min(best, 1))
    # confidence: cepstral peak vs mean magnitude in range (threshold .3)
    mean_abs = torch.sum(torch.where(valid, torch.abs(ceps), 0.0), dim=-1) / torch.clamp_min(
        torch.sum(valid, dim=-1), 1)
    conf = torch.clamp(val / torch.clamp_min(mean_abs * 4.0, _EPS), 0.0, 1.0)
    ok = (pitch >= params.min_freq) & (pitch <= params.max_freq) & (val > 0)
    return torch.where(ok, pitch, 0.0), torch.where(ok, conf, 0.0)


def zcr_pitch(frames: torch.Tensor, params: PitchParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-crossing pitch (pitch_detection.go:694-728): f ~ crossings
    * sr / (2 W). Low confidence by construction."""
    w = frames.shape[-1]
    nonneg = frames >= 0
    crossings = torch.sum((nonneg[..., 1:] != nonneg[..., :-1]).to(torch.float32), dim=-1)
    pitch = crossings * params.sample_rate / (2.0 * w)
    ok = (pitch >= params.min_freq) & (pitch <= params.max_freq)
    return torch.where(ok, pitch, 0.0), torch.where(ok, 0.3, 0.0)


@dataclass
class PitchDetectionResult:
    pitch: torch.Tensor
    confidence: torch.Tensor
    voicing: torch.Tensor
    method: str


class PitchDetector:
    """PitchDetector.DetectPitch facade (pitch_detection.go:14-207).

    Methods: yin, acf, nsdf, hps, cepstrum, zcr, peaks; hybrids
    'yin+acf' etc. average agreeing estimates (:730-741). Octave
    correction and median filtering follow the reference post-processing
    (:767-900).
    """

    def __init__(self, sample_rate: int, method: str = "yin",
                 params: Optional[PitchParams] = None, device: Device = DEFAULT_DEVICE):
        self.method = method
        self.params = params or PitchParams(sample_rate=sample_rate)
        self.sample_rate = sample_rate
        self.device = device

    def _single(self, frames: torch.Tensor, method: str):
        if method == "yin":
            p, c, _ = yin_pitch(frames, self.params)
            return p, c
        if method == "acf":
            return acf_pitch(frames, self.params)
        if method == "nsdf":
            return nsdf_pitch(frames, self.params)
        if method == "cepstrum":
            return cepstrum_pitch(frames, self.params)
        if method == "zcr":
            return zcr_pitch(frames, self.params)
        if method == "peaks":
            # strongest spectral peak as the pitch estimate
            # (pitch_detection.go:687-692)
            w = frames.shape[-1]
            spec = torch.abs(torch.fft.rfft(frames.to(torch.float32), dim=-1))
            freqs, mags, count = detect_spectral_peaks(spec, self.sample_rate, w, max_peaks=4)
            p = freqs[..., 0]
            ok = (p >= self.params.min_freq) & (p <= self.params.max_freq) & (count > 0)
            total = torch.sum(spec, dim=-1)
            conf = torch.where(
                ok & (total > _EPS),
                torch.clamp(mags[..., 0] / torch.clamp_min(total, _EPS) * 4.0, 0.0, 1.0), 0.0,
            )
            return torch.where(ok, p, 0.0), conf
        if method == "hps":
            w = frames.shape[-1]
            spec = torch.abs(torch.fft.rfft(frames.to(torch.float32), dim=-1))
            p = estimate_f0_hps(spec, self.sample_rate, w, self.params.min_freq, self.params.max_freq)
            return p, torch.where(p > 0, 0.5, 0.0)
        raise ValueError(f"unknown pitch method {method}")

    def detect(self, frames) -> PitchDetectionResult:
        frames = as_float32(frames, self.device)
        methods = self.method.split("+")
        if len(methods) == 1:
            p, c = self._single(frames, methods[0])
        else:
            # hybrid: average estimates that agree within 10% (:730-741)
            ps, cs = zip(*(self._single(frames, m) for m in methods))
            p0 = ps[0]
            agree_sum = torch.zeros_like(p0)
            agree_cnt = torch.zeros_like(p0)
            conf_sum = torch.zeros_like(p0)
            for p_i, c_i in zip(ps, cs):
                agrees = (p_i > 0) & (p0 > 0) & (torch.abs(p_i - p0) / torch.clamp_min(p0, _EPS) < 0.1)
                agree_sum = agree_sum + torch.where(agrees, p_i, 0.0)
                agree_cnt = agree_cnt + agrees
                conf_sum = conf_sum + torch.where(agrees, c_i, 0.0)
            n = torch.clamp_min(agree_cnt, 1)
            p = torch.where(agree_cnt > 0, agree_sum / n, 0.0)
            c = torch.where(agree_cnt > 0, conf_sum / n, 0.0)
        return PitchDetectionResult(p, c, c, self.method)

    def detect_track(
        self, pcm, frame_size: int = 1024, hop_size: int = 512,
        octave_correct: bool = True, median_width: int = 5,
    ) -> PitchDetectionResult:
        """Frame-wise track + octave correction + median filter
        (pitch_detection.go:767-900)."""
        res = self.detect(frame_signal(as_float32(pcm, self.device), frame_size, hop_size))
        pitch = res.pitch
        if octave_correct:
            pitch = correct_octave_errors(pitch)
        if median_width > 1:
            pitch = torch.where(pitch > 0, median_filter_pitch(pitch, median_width), 0.0)
        return PitchDetectionResult(pitch, res.confidence, res.voicing, self.method)


def correct_octave_errors(pitch: torch.Tensor) -> torch.Tensor:
    """Fix isolated octave jumps against the running median
    (pitch_detection.go octave correction); a window that holds an
    unvoiced frame has no median (NaN, then 0)."""
    med = median_filter_pitch(torch.where(pitch > 0, pitch, float("nan")), 5)
    med = torch.where(torch.isnan(med), 0.0, med)
    ratio = torch.where(med > 0, pitch / torch.clamp_min(med, _EPS), 1.0)
    halved = torch.where((ratio > 1.8) & (ratio < 2.2), pitch / 2.0, pitch)
    doubled = torch.where((ratio > 0.45) & (ratio < 0.55), halved * 2.0, halved)
    return torch.where(pitch > 0, doubled, 0.0)


def analyze_vibrato(
    pitch: torch.Tensor, hop_size: int, sample_rate: int
) -> Dict[str, torch.Tensor]:
    """Vibrato rate/extent from the voiced pitch track
    (pitch_detection.go:1000-1116): detrended pitch contour -> dominant
    modulation frequency in 3-10 Hz."""
    voiced = pitch > 0
    frame_rate = sample_rate / hop_size
    n_voiced = torch.clamp_min(torch.sum(voiced, dim=-1), 1)
    mean_p = torch.sum(torch.where(voiced, pitch, 0.0), dim=-1) / n_voiced
    contour = torch.where(voiced, pitch - mean_p[..., None], 0.0)
    t = contour.shape[-1]
    n_fft = 1
    while n_fft < 2 * t:
        n_fft <<= 1
    spec = torch.abs(torch.fft.rfft(contour, n=n_fft, dim=-1))
    freqs = torch.arange(spec.shape[-1], device=spec.device) * frame_rate / n_fft
    band = (freqs >= 3.0) & (freqs <= 10.0)
    masked = torch.where(band, spec, -_INF)
    best = torch.argmax(masked, dim=-1)
    rate = freqs[best]
    extent = 2.0 * torch.gather(spec, -1, best[..., None])[..., 0] / n_voiced
    present = torch.isfinite(torch.amax(masked, dim=-1)) & (extent > 1.0)
    return {
        "vibrato_rate_hz": torch.where(present, rate, 0.0),
        "vibrato_extent_hz": torch.where(present, extent, 0.0),
        "has_vibrato": present,
    }
