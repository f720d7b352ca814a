"""The chip's published peaks (`peaks.json`) and the least time of a
piece of work under them: the larger of its bytes over the memory rate
and its operations over the float32 rate outside the tensor cores."""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def least_seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAKS["hbm_bytes_per_s"], ops / PEAKS["fp32_ops_per_s"])
