"""Percentiles / quantiles.

Reference parity: algorithms/stats/percentiles.go:10-622 — nine quantile
estimation methods (Hyndman-Fan types 1-9: inverted CDF, averaged
inverted CDF, closest observation, interpolated inverted CDF, Hazen,
Weibull, linear/R-default, median-unbiased, normal-unbiased), quartiles,
IQR outlier fences, summary statistics.

Counterpart of `sonido_sonar_tpu/ops/stats/percentiles.py`: host numpy
in float64, as there (`torch.quantile` has five of the nine methods).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

_HF_METHODS = {
    "inverted_cdf": "inverted_cdf",
    "averaged_inverted_cdf": "averaged_inverted_cdf",
    "closest_observation": "closest_observation",
    "interpolated_inverted_cdf": "interpolated_inverted_cdf",
    "hazen": "hazen",
    "weibull": "weibull",
    "linear": "linear",                       # R default (type 7)
    "median_unbiased": "median_unbiased",     # type 8
    "normal_unbiased": "normal_unbiased",     # type 9
}


def calculate_percentile(x, p: float, method: str = "linear") -> float:
    """Percentiles.CalculatePercentile (percentiles.go:198-...).

    p in [0, 100]; method one of the nine Hyndman-Fan estimators.
    """
    if method not in _HF_METHODS:
        raise ValueError(f"unknown quantile method {method}")
    return float(
        np.quantile(np.asarray(x, dtype=np.float64), p / 100.0, method=_HF_METHODS[method])
    )


def quartiles(x, method: str = "linear") -> Tuple[float, float, float]:
    return (
        calculate_percentile(x, 25, method),
        calculate_percentile(x, 50, method),
        calculate_percentile(x, 75, method),
    )


def outlier_fences(x, k: float = 1.5) -> Dict[str, float]:
    """Tukey IQR fences (percentiles.go outlier detection)."""
    q1, q2, q3 = quartiles(x)
    iqr = q3 - q1
    lower = q1 - k * iqr
    upper = q3 + k * iqr
    arr = np.asarray(x, dtype=np.float64)
    outliers = int(((arr < lower) | (arr > upper)).sum())
    return {
        "q1": q1, "median": q2, "q3": q3, "iqr": iqr,
        "lower_fence": lower, "upper_fence": upper,
        "num_outliers": float(outliers),
    }


def analyze(x, method: str = "linear") -> Dict[str, float]:
    """Percentiles.Analyze (percentiles.go:10-126): summary statistics."""
    arr = np.asarray(x, dtype=np.float64)
    if arr.size == 0:
        return {}
    q1, q2, q3 = quartiles(arr, method)
    return {
        "min": float(arr.min()),
        "max": float(arr.max()),
        "range": float(arr.max() - arr.min()),
        "p5": calculate_percentile(arr, 5, method),
        "p10": calculate_percentile(arr, 10, method),
        "q1": q1,
        "median": q2,
        "q3": q3,
        "p90": calculate_percentile(arr, 90, method),
        "p95": calculate_percentile(arr, 95, method),
        "iqr": q3 - q1,
        "midhinge": (q1 + q3) / 2.0,
        "trimean": (q1 + 2 * q2 + q3) / 4.0,
    }
