"""Driver of `BatchedFingerprintPipeline` on a one-entry mesh (the card)
through `run_stream` (`parallel/pipeline.py`): a closed loop that keeps
`drain_every + 1` batches in flight and takes each result once its
event has completed.

The traffic's `feed` says where the batches wait: "host" hands
`run_stream` numpy batches in host memory (it stages each in pinned
memory and uploads it), "device" hands it batches already on the card.
Set-up makes the `distinct` batches on the card from the seed (copied
to host memory for "host"), builds the pipeline and runs as many warm
batches as are in flight, so the staging buffers exist before the
window. A call is one batch; it completes when `run_stream` yields it.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.core import spec as S
from benchmark.core import window as W


class Driver:
    def __init__(self, config: dict, traffic: dict, check: dict, seed: int, device):
        from sonido_sonar_tpu_torch.config.config import FeatureConfig, WindowType
        from sonido_sonar_tpu_torch.parallel.mesh import make_mesh
        from sonido_sonar_tpu_torch.parallel.pipeline import BatchedFingerprintPipeline, run_stream

        self.cfg = config
        self.device = torch.device(device)
        self.sr = int(config["sample_rate"])
        if (traffic["batch"], traffic["clip_seconds"]) != (config["batch"], config["clip_seconds"]):
            raise ValueError("the traffic's batch shape differs from the configuration's")
        batches = S.traffic(traffic, seed, self.device, self.sr)
        self.audio_s = float(traffic["batch"] * traffic["clip_seconds"])
        self.host = [b.cpu().numpy() for b in batches]   # what the check rebuilds from
        self.inputs = {"host": self.host, "device": batches}[traffic["feed"]]
        self.drain_every = int(traffic["drain_every"])
        self._run_stream = run_stream
        self.pipe = BatchedFingerprintPipeline(
            make_mesh(devices=[self.device]),
            FeatureConfig(sample_rate=self.sr, window_size=int(config["window_size"]),
                          hop_size=int(config["hop_size"]), window_type=WindowType(config["window_type"]),
                          mfcc_coefficients=int(config["mfcc_coefficients"]),
                          enable_chroma=bool(config["enable_chroma"]),
                          enable_spectral_contrast=bool(config["enable_contrast"])))
        self.rng = np.random.default_rng([int(seed) & ((1 << 63) - 1), 0x5EED])
        # batches kept for the check: drawn from the seed among the first
        # `sample_pool`, and the window's last
        pool, n = int(check["sample_pool"]), int(check["sample"])
        self.keep_at = set(self.rng.choice(pool, size=n - 1, replace=False).tolist())
        self.kept: Dict[int, dict] = {}
        self.count = 0
        self.run_calls(self.drain_every + 1)   # the warm batches
        self.kept.clear()

    def _stream(self, n_or_window):
        """Run batches through run_stream: `n` of them, or until the
        window closes; -> list of (start, end, index)."""
        state = {"stop": False, "starts": []}
        win = n_or_window if isinstance(n_or_window, W.Window) else None
        limit = None if win else int(n_or_window)

        def feed():
            i = 0
            while not state["stop"] and (limit is None or i < limit):
                state["starts"].append(time.perf_counter())
                yield self.inputs[(self.count + i) % len(self.inputs)]
                i += 1

        done = []
        for out in self._run_stream(self.pipe, feed(), drain_every=self.drain_every, device=self.device):
            end = time.perf_counter()
            idx = self.count + len(done)
            done.append((state["starts"][len(done)], end, idx))
            if win is not None:
                if end <= win.t_end:
                    self.last = (idx, out)
                    if idx - self.first in self.keep_at:
                        self.kept[idx] = out
                else:
                    state["stop"] = True
        self.count += len(done)
        return done

    def run_window(self, seconds: float) -> W.Window:
        self.first = self.count
        self.last = None
        win = W.Window(time.perf_counter(), float(seconds))
        for start, end, _ in self._stream(win):
            win.calls.append(W.Call(start, end, {"audio_s": self.audio_s}))
        if self.last is not None:
            self.kept[self.last[0]] = self.last[1]
        return win

    def run_calls(self, n: int) -> int:
        self._stream(n)
        return n

    def sample(self, rng, n_calls: int, window_calls: int) -> List[dict]:
        """The kept batches of the window (drawn at set-up from the seed,
        and the last one completed inside it); the pipeline is freed."""
        picks = [{"index": i, "input": i % len(self.inputs), "out": out}
                 for i, out in sorted(self.kept.items())]
        self.pipe = None
        self.kept = {}
        return picks

    def expected(self, reference, s: dict, lowp: bool) -> dict:
        pcm = torch.from_numpy(self.host[s["input"]]).to(self.device)
        return reference.features(pcm, self.cfg, lowp=lowp)

    def as_program(self, expected: dict) -> dict:
        return {"out": expected}

    def compare(self, reference, program: List[dict], expected: List[dict]) -> Dict[str, float]:
        return reference.compare([p["out"] for p in program], expected)
