"""Cross-correlation with peak-quality metrics.

Counterpart of `sonido_sonar_tpu/ops/stats/correlation.py` (reference
parity: correlation.go — z-normalized FFT path zero-padded to the next
power of two of n1 + n2 - 1, negative lags from the tail; auto-switch to
FFT above 1000 samples; max lag clamped to min(len) - 1; peak = max
|corr|; SNR excluding +-5 bins, sharpness = -(second difference), second
peak, peak-to-sidelobe excluding +-10 bins, step-function p-value). The
lag axis comes from one `torch.fft.rfft`/`irfft` pair; everything
batches over leading axes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_MIN_STD = 1e-10


def _next_pow2(n: int) -> int:
    k = 1
    while k < n:
        k <<= 1
    return k


@dataclass
class CorrelationResult:
    """CorrelationResult (correlation.go:43-73). Arrays batch over
    leading axes; `lags` is shared across the batch."""

    correlations: torch.Tensor     # [..., 2*max_lag+1]
    lags: torch.Tensor             # [2*max_lag+1] int32
    peak_correlation: torch.Tensor
    peak_lag: torch.Tensor         # int32
    peak_index: torch.Tensor       # int32
    p_value: torch.Tensor
    snr: torch.Tensor
    sharpness: torch.Tensor
    second_peak: torch.Tensor
    peak_to_sidelobe: torch.Tensor
    overlap_length: torch.Tensor
    max_lag: int


def z_normalize(signal: torch.Tensor) -> torch.Tensor:
    """Zero mean, unit variance; a constant signal only loses its mean
    (correlation.go:464-502)."""
    mean = torch.mean(signal, dim=-1, keepdim=True)
    centered = signal - mean
    std = torch.sqrt(torch.mean(centered * centered, dim=-1, keepdim=True))
    return torch.where(std < _MIN_STD, centered, centered / torch.clamp_min(std, _MIN_STD))


def lag_window(corr_full: torch.Tensor, size: int, max_lag: int) -> torch.Tensor:
    """Lags -max_lag..max_lag of a circular correlation of length `size`
    (negative lags live at its tail)."""
    pos = corr_full[..., : max_lag + 1]
    if max_lag == 0:
        return pos
    return torch.cat([corr_full[..., size - max_lag:], pos], dim=-1)


def _fft_correlations(x1: torch.Tensor, x2: torch.Tensor, max_lag: int, n1: int, n2: int,
                      normalize_inputs: bool) -> torch.Tensor:
    if normalize_inputs:
        x1 = z_normalize(x1)
        x2 = z_normalize(x2)
    size = _next_pow2(n1 + n2 - 1)
    f1 = torch.fft.rfft(x1, n=size, dim=-1)
    f2 = torch.fft.rfft(x2, n=size, dim=-1)
    corr_full = torch.fft.irfft(f1 * torch.conj(f2), n=size, dim=-1)
    return lag_window(corr_full, size, max_lag)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, idx[..., None])[..., 0]


def _peak_metrics(correlations: torch.Tensor, max_lag: int, n1: int, n2: int):
    """(peak_corr, peak_lag, peak_index, p_value, snr, sharpness,
    second_peak, psl, overlap), each [...] (correlation.go:526-668)."""
    num_lags = 2 * max_lag + 1
    dev = correlations.device
    idx = torch.arange(num_lags, device=dev)
    abs_c = torch.abs(correlations)

    peak_index = torch.argmax(abs_c, dim=-1)
    peak_corr = _take(correlations, peak_index)
    peak_lag = (peak_index - max_lag).to(torch.int32)

    far5 = torch.abs(idx - peak_index[..., None]) > 5
    noise_cnt = torch.sum(far5, dim=-1)
    noise_pow = torch.sum(torch.where(far5, correlations * correlations, 0.0), dim=-1)
    noise = torch.sqrt(noise_pow / torch.clamp_min(noise_cnt, 1))
    snr = torch.where(
        noise_cnt == 0, 0.0,
        torch.where(noise < _MIN_STD, float("inf"),
                    20.0 * torch.log10(torch.abs(peak_corr) / torch.clamp_min(noise, _MIN_STD))),
    )

    c_m = _take(correlations, torch.clamp(peak_index - 1, 0, num_lags - 1))
    c_p = _take(correlations, torch.clamp(peak_index + 1, 0, num_lags - 1))
    interior = (peak_index > 0) & (peak_index < num_lags - 1)
    sharpness = torch.where(interior, -(c_p - 2.0 * peak_corr + c_m), 0.0)

    masked = torch.where(idx == peak_index[..., None], float("-inf"), abs_c)
    second_peak = _take(correlations, torch.argmax(masked, dim=-1))

    far10 = torch.abs(idx - peak_index[..., None]) > 10
    sidelobe = torch.amax(torch.where(far10, abs_c, 0.0), dim=-1)
    psl = torch.where(
        sidelobe < _MIN_STD, float("inf"),
        20.0 * torch.log10(torch.abs(peak_corr) / torch.clamp_min(sidelobe, _MIN_STD)),
    )

    n = min(n1, n2)
    r = torch.abs(peak_corr)
    t = r * float(max(n - 2, 0)) ** 0.5 / torch.sqrt(torch.clamp_min(1.0 - r * r, _MIN_STD))
    p_value = torch.where(t > 2.0, 0.01, torch.where(t > 1.5, 0.05, torch.where(t > 1.0, 0.1, 0.5)))
    if n <= 2:
        p_value = torch.ones_like(p_value)

    overlap = torch.where(
        peak_lag >= 0,
        torch.clamp_max(n2 - peak_lag, n1),
        torch.clamp_max(n1 + peak_lag, n2),
    )
    return (peak_corr, peak_lag, peak_index.to(torch.int32), p_value, snr, sharpness,
            second_peak, psl, overlap)


def _result(corr: torch.Tensor, max_lag: int, n1: int, n2: int) -> CorrelationResult:
    lags = torch.arange(-max_lag, max_lag + 1, dtype=torch.int32, device=corr.device)
    return CorrelationResult(corr, lags, *_peak_metrics(corr, max_lag, n1, n2), max_lag=max_lag)


def cross_correlate_fft(signal1: torch.Tensor, signal2: torch.Tensor, max_lag: int,
                        normalize_inputs: bool = True) -> CorrelationResult:
    """FFT cross-correlation over +-max_lag with full peak metrics:
    corr[lag] = sum_n z(x1)[n] z(x2)[n - lag] (correlation.go:231-290); a
    positive peak lag means signal2 is advanced (signal1 delayed)."""
    n1, n2 = signal1.shape[-1], signal2.shape[-1]
    max_lag = max(min(max_lag, n1 - 1, n2 - 1), 0)
    corr = _fft_correlations(signal1.to(torch.float32), signal2.to(torch.float32),
                             max_lag, n1, n2, normalize_inputs)
    return _result(corr, max_lag, n1, n2)


def _per_lag_overlap_correlations(x1: torch.Tensor, x2: torch.Tensor, max_lag: int,
                                  kind: str) -> torch.Tensor:
    """Per-lag overlap correlations, kind pearson | ncc | zncc
    (correlation.go:300-417), on the FFT path's lag convention (the JAX
    package's documented deviation): x1[j] pairs with x2[j - lag]."""
    n1, n2 = x1.shape[-1], x2.shape[-1]
    if kind == "zncc":
        x1 = x1 - torch.mean(x1, dim=-1, keepdim=True)
        x2 = x2 - torch.mean(x2, dim=-1, keepdim=True)
        kind = "ncc"
    dev = x1.device
    lags = torch.arange(-max_lag, max_lag + 1, device=dev)[:, None]     # [L, 1]
    i = torch.arange(max(n1, n2), device=dev)[None, :]                   # [1, n]
    j2 = i - lags
    valid = (i < n1) & (j2 >= 0) & (j2 < n2)                              # [L, n]
    v1 = torch.where(valid, x1[..., torch.clamp(i, 0, n1 - 1)], 0.0)                # [..., L, n]
    v2 = torch.where(valid, x2[..., torch.clamp(j2, 0, n2 - 1)], 0.0)
    if kind == "pearson":
        cnt = torch.clamp_min(torch.sum(valid, dim=-1), 1)
        m1 = torch.sum(v1, dim=-1) / cnt
        m2 = torch.sum(v2, dim=-1) / cnt
        v1 = torch.where(valid, v1 - m1[..., None], 0.0)
        v2 = torch.where(valid, v2 - m2[..., None], 0.0)
    num = torch.sum(v1 * v2, dim=-1)
    den = torch.sqrt(torch.sum(v1 * v1, dim=-1) * torch.sum(v2 * v2, dim=-1))
    c = torch.where(den < _MIN_STD, 0.0, num / torch.clamp_min(den, _MIN_STD))
    if kind == "pearson":
        c = torch.clamp(c, -1.0, 1.0)
    return c


def cross_correlate_pearson(signal1: torch.Tensor, signal2: torch.Tensor, max_lag: int,
                            correlation_type: str = "pearson") -> CorrelationResult:
    """Per-lag correlation over the overlap region, the reference's
    time-domain / sliding-window path (correlation.go:203-229, 293-417)."""
    n1, n2 = signal1.shape[-1], signal2.shape[-1]
    max_lag = max(min(max_lag, n1 - 1, n2 - 1), 0)
    corr = _per_lag_overlap_correlations(signal1.to(torch.float32), signal2.to(torch.float32),
                                         max_lag, correlation_type)
    return _result(corr, max_lag, n1, n2)


def cross_correlate(signal1: torch.Tensor, signal2: torch.Tensor, max_lag: int,
                    method: str = "auto", normalize_inputs: bool = True,
                    fft_threshold: int = 1000, correlation_type: str = "pearson"
                    ) -> CorrelationResult:
    """Method dispatch of CrossCorrelation.Compute (correlation.go:131-200)."""
    n = max(signal1.shape[-1], signal2.shape[-1])
    if method == "fft" or (method == "auto" and n > fft_threshold):
        return cross_correlate_fft(signal1, signal2, max_lag, normalize_inputs)
    if method in ("time", "auto", "sliding"):
        return cross_correlate_pearson(signal1, signal2, max_lag, correlation_type)
    raise ValueError(f"unknown correlation method {method}")


def autocorrelate(signal: torch.Tensor, max_lag: int) -> CorrelationResult:
    """AutoCorrelation.Compute (correlation.go:668-690)."""
    return cross_correlate(signal, signal, max_lag)
