"""Multi-frame harmonic partial tracking (counterpart of
`sonido_sonar_tpu/ops/tracking.py`).

Reference parity: algorithms/harmonic/harmonic_tracking.go —
  method enum PeakBased / SinusoidalModel / PartialTracking /
  KalmanFilter / MultiFrame, where only PeakBased is genuinely
  implemented and the others fall back to it (:339-366 — preserved);
  defaults (:179-194): max freq deviation 50 Hz, max amp deviation
  20 dB, continuity weights freq .6 / amp .3 / phase .1, birth
  threshold 0.3, max gap 2 frames, median filter 5, min confidence 0.2;
  greedy match: continue tracks with the best-scoring unused peak,
  birth new tracks for strong unmatched peaks, kill tracks gapped
  longer than max_gap (:297-440).

Peak detection runs on the device over the whole spectrogram
(`ops/harmonic.detect_spectral_peaks`); the birth, match and death
bookkeeping is sequential and runs on the host, in float64 numpy over
the fetched fixed-k peak arrays, in the reference's track-list order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from sonido_sonar_tpu_torch.ops.harmonic import detect_spectral_peaks
from sonido_sonar_tpu_torch.utils.device import DEFAULT_DEVICE, Device, as_float32


@dataclass(frozen=True)
class TrackingParams:
    """HarmonicTrackingParams defaults (harmonic_tracking.go:179-194)."""

    method: str = "peak_based"   # others fall back, as upstream
    max_freq_deviation: float = 50.0
    max_amp_deviation_db: float = 20.0
    freq_continuity_weight: float = 0.6
    amp_continuity_weight: float = 0.3
    phase_continuity_weight: float = 0.1
    birth_threshold: float = 0.3
    max_gap_length: int = 2
    min_track_length: int = 3
    max_peaks: int = 16


@dataclass
class HarmonicTrack:
    """HarmonicTrack (harmonic_tracking.go:13-35)."""

    track_id: int
    start_frame: int
    end_frame: int
    frequencies: List[float] = field(default_factory=list)
    amplitudes: List[float] = field(default_factory=list)
    frames: List[int] = field(default_factory=list)

    @property
    def length(self) -> int:
        return len(self.frequencies)

    @property
    def mean_frequency(self) -> float:
        return float(np.mean(self.frequencies)) if self.frequencies else 0.0


@dataclass
class HarmonicTrackingResult:
    tracks: List[HarmonicTrack]
    num_frames: int

    @property
    def num_tracks(self) -> int:
        return len(self.tracks)


class HarmonicTracking:
    """HarmonicTracking (harmonic_tracking.go:13-214). A tensor stays on
    its device; numpy input goes to `device`."""

    def __init__(self, sample_rate: int, params: Optional[TrackingParams] = None,
                 device: Device = DEFAULT_DEVICE):
        self.sample_rate = sample_rate
        self.params = params or TrackingParams()
        self.device = device

    def process_magnitude_spectrogram(
        self, magnitude, window_size: int
    ) -> HarmonicTrackingResult:
        """ProcessMagnitudeSpectrogram (harmonic_tracking.go:262-289).

        magnitude: [T, F] frames.
        """
        p = self.params
        freqs, mags, counts = detect_spectral_peaks(
            as_float32(magnitude, self.device), self.sample_rate, window_size,
            max_peaks=p.max_peaks,
        )
        freqs_np = freqs.cpu().numpy()
        mags_np = mags.cpu().numpy()
        counts_np = counts.cpu().numpy()
        t_frames = freqs_np.shape[0]

        # normalize amplitudes for the birth threshold (relative to the
        # spectrogram's global peak)
        global_max = float(mags_np.max()) or 1.0

        tracks: List[HarmonicTrack] = []
        next_id = 1
        # live-track state as parallel arrays: the per-frame track x
        # peak score matrix is one vectorized computation; the greedy
        # assignment stays in the reference's track-list order (:297-336)
        last_f = np.zeros(0)
        last_a = np.zeros(0)
        end_frame = np.zeros(0, dtype=np.int64)

        for t in range(t_frames):
            k = int(counts_np[t])
            frame_freqs = freqs_np[t, :k].astype(np.float64)
            frame_mags = mags_np[t, :k].astype(np.float64)
            used = np.zeros(k, dtype=bool)

            gap = (t - 1) - end_frame
            live_idx = np.nonzero((gap <= p.max_gap_length - 1) & (end_frame < t))[0]
            if k and len(live_idx):
                lf = last_f[live_idx][:, None]
                la = np.maximum(last_a[live_idx][:, None], 1e-10)
                df = np.abs(frame_freqs[None, :] - lf)
                da_db = np.abs(20.0 * np.log10(np.maximum(frame_mags[None, :], 1e-10) / la))
                ok = (df <= p.max_freq_deviation) & (da_db <= p.max_amp_deviation_db)
                score = (
                    p.freq_continuity_weight * (1.0 - df / p.max_freq_deviation)
                    + p.amp_continuity_weight * (1.0 - da_db / p.max_amp_deviation_db)
                    + p.phase_continuity_weight * 0.5  # no phase info
                )
                score = np.where(ok, score, -np.inf)
                # greedy in track order (argmax keeps the first of equal
                # scores, matching the reference's strict-greater scan)
                for row, ti in enumerate(live_idx):
                    s = np.where(used, -np.inf, score[row])
                    best = int(np.argmax(s))
                    if s[best] == -np.inf:
                        continue
                    trk = tracks[ti]
                    trk.frequencies.append(float(frame_freqs[best]))
                    trk.amplitudes.append(float(frame_mags[best]))
                    trk.frames.append(t)
                    trk.end_frame = t
                    last_f[ti] = frame_freqs[best]
                    last_a[ti] = frame_mags[best]
                    end_frame[ti] = t
                    used[best] = True

            # birth (:328-333): strong unmatched peaks
            born_idx = np.nonzero((~used) & (frame_mags / global_max >= p.birth_threshold))[0]
            if len(born_idx):
                for i in born_idx:
                    tracks.append(HarmonicTrack(
                        track_id=next_id, start_frame=t, end_frame=t,
                        frequencies=[float(frame_freqs[i])],
                        amplitudes=[float(frame_mags[i])], frames=[t],
                    ))
                    next_id += 1
                last_f = np.concatenate([last_f, frame_freqs[born_idx]])
                last_a = np.concatenate([last_a, frame_mags[born_idx]])
                end_frame = np.concatenate([end_frame, np.full(len(born_idx), t, dtype=np.int64)])

        # finalize: drop short tracks (finalizeTracks)
        tracks = [trk for trk in tracks if trk.length >= p.min_track_length]
        return HarmonicTrackingResult(tracks=tracks, num_frames=t_frames)

    def process_spectrogram(
        self, complex_spec, window_size: int
    ) -> HarmonicTrackingResult:
        """ProcessSpectrogram (harmonic_tracking.go:237-260): magnitude
        path (phase tracking off by default upstream)."""
        if not isinstance(complex_spec, torch.Tensor):
            complex_spec = torch.as_tensor(np.asarray(complex_spec), device=torch.device(self.device))
        return self.process_magnitude_spectrogram(torch.abs(complex_spec), window_size)
