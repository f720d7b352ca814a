"""Driver of the port's public entry point, `FingerprintGenerator.
generate_fingerprints_batch` (`fingerprint/generator.py`), at upstream's
`DefaultFingerprintConfig` with content detection on and strict
routing: a closed loop, one batch a call, each call returning the
batch's `AudioFingerprint` objects with host features (`materialize`).

Set-up makes the `distinct` batches on the card from the seed, wraps
each row as an `AudioData` with no metadata (so the acoustic detector
decides every clip), builds the generator and runs every batch once, so
each content-type group's shapes are warm before the window. A call is
one batch; it completes when its fingerprints are on the host. The
fingerprints of the sampled batches (drawn at set-up among the window's
first `sample_pool`, and the window's last) are kept for the check.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from collections import Counter
from typing import Dict, List

import numpy as np
import torch

from benchmark.core import spec as S
from benchmark.core import window as W


def flat(features) -> Dict[str, np.ndarray]:
    """A clip's `ExtractedFeatures` as {field path: array}, None fields
    and metadata left out."""
    out: Dict[str, np.ndarray] = {}
    for f in dataclasses.fields(features):
        v = getattr(features, f.name)
        if v is None or f.name == "metadata":
            continue
        if dataclasses.is_dataclass(v):
            for g in dataclasses.fields(v):
                w = getattr(v, g.name)
                if w is not None:
                    out[f"{f.name}.{g.name}"] = w
        else:
            out[f.name] = v
    return out


def as_checked(fingerprints) -> dict:
    """The batch's fingerprints in the reference's form."""
    return {"types": [fp.content_type.value for fp in fingerprints],
            "subtypes": [fp.features.metadata.get("content_subtype") for fp in fingerprints],
            "rows": [flat(fp.features) for fp in fingerprints]}


class Driver:
    def __init__(self, config: dict, traffic: dict, check: dict, seed: int, device):
        from sonido_sonar_tpu_torch.config.config import FeatureConfig, FingerprintConfig, WindowType
        from sonido_sonar_tpu_torch.fingerprint import FingerprintGenerator
        from sonido_sonar_tpu_torch.io.audio import AudioData

        self.cfg = config
        self.device = torch.device(device)
        sr = int(config["sample_rate"])
        if (traffic["batch"], traffic["clip_seconds"]) != (config["batch"], config["clip_seconds"]):
            raise ValueError("the traffic's batch shape differs from the configuration's")
        self.batches = S.traffic(traffic, seed, self.device, sr)
        self.audios = [[AudioData(row, sr) for row in b] for b in self.batches]
        self.audio_s = float(traffic["batch"] * traffic["clip_seconds"])
        fp_config = FingerprintConfig(feature_config=FeatureConfig(
            sample_rate=sr, window_size=int(config["window_size"]), hop_size=int(config["hop_size"]),
            window_type=WindowType(config["window_type"]),
            mfcc_coefficients=int(config["mfcc_coefficients"]),
            contrast_bands=int(config["contrast_bands"])))
        if not (fp_config.content_aware.enable_content_detection and config["content_detection"]
                and config["materialize"]):
            raise ValueError("the configuration runs with content detection on and materialized output")
        self.gen = FingerprintGenerator(fp_config, strict_reference_routing=bool(config["strict_reference_routing"]),
                                        device=self.device)
        self.rng = np.random.default_rng([int(seed) & ((1 << 63) - 1), 0x5EED])
        pool, n = int(check["sample_pool"]), int(check["sample"])
        self.keep_at = set(self.rng.choice(pool, size=n - 1, replace=False).tolist())
        self.kept: Dict[int, list] = {}
        self.count = 0
        for i in range(len(self.batches)):   # the warm batches, every group's shapes
            types = Counter(fp.content_type.value for fp in self._call())
            print(f"batch {i}: content types {dict(sorted(types.items()))}", file=sys.stderr)

    def _call(self):
        i = self.count % len(self.batches)
        fps = self.gen.generate_fingerprints_batch(self.audios[i], pcm_matrix=self.batches[i],
                                                   materialize=True)
        self.count += 1
        return fps

    def run_window(self, seconds: float) -> W.Window:
        """The closed loop; keeps the sampled batches and the last one
        completed inside the window (the one running at its close where
        none did, so the check always has a batch)."""
        first, last = self.count, None
        win = W.Window(time.perf_counter(), float(seconds))
        while True:
            start = time.perf_counter()
            if start >= win.t_end:
                break
            idx = self.count
            fps = self._call()
            end = time.perf_counter()
            win.calls.append(W.Call(start, end, {"audio_s": self.audio_s}))
            if end <= win.t_end or last is None:
                last = (idx, fps)
            if end <= win.t_end and idx - first in self.keep_at:
                self.kept[idx] = fps
        self.kept[last[0]] = last[1]
        return win

    def run_calls(self, n: int) -> int:
        for _ in range(n):
            self._call()
        return n

    def sample(self, rng, n_calls: int, window_calls: int) -> List[dict]:
        """The kept batches of the window; the generator is freed."""
        picks = [{"index": i, "input": i % len(self.batches), "out": as_checked(fps)}
                 for i, fps in sorted(self.kept.items())]
        self.gen = None
        self.kept = {}
        return picks

    def expected(self, reference, s: dict, lowp: bool) -> dict:
        return reference.fingerprints(self.batches[s["input"]], self.cfg, lowp=lowp)

    def as_program(self, expected: dict) -> dict:
        return {"out": expected}

    def compare(self, reference, program: List[dict], expected: List[dict]) -> Dict[str, float]:
        return reference.compare([p["out"] for p in program], expected)
