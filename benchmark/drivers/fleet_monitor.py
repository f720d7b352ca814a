"""Driver of `FleetMonitor` (the port's `monitor.py`): one call pushes
`advance_seconds` of new audio per stream and side from host memory,
then runs `measure_all(refine=...)` up to the measurements on the host.

Set-up makes the traffic on the device from the seed, copies the rings
to host memory as numpy arrays in ordinary (pageable) memory, what a
decoder hands over, fills the 60 s windows and makes one warm call of
the cell's own shape. A push hands the monitor one numpy chunk
[streams, samples] per side. The check recomputes sampled calls'
measurements with the plain reference from the same chunks.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.core import spec as S
from benchmark.core import window as W


def _row(m) -> dict | None:
    if m is None:
        return None
    return {"latency_s": float(m.latency_s), "confidence": float(m.confidence),
            "similarity": float(m.similarity), "method": m.method, "time_s": float(m.time_s)}


class Driver:
    def __init__(self, config: dict, traffic: dict, check: dict, seed: int, device):
        from sonido_sonar_tpu_torch.config.config import FeatureConfig
        from sonido_sonar_tpu_torch.monitor import FleetMonitor

        self.cfg = config
        self.device = torch.device(device)
        self.sr = int(config["sample_rate"])
        if traffic["streams"] != config["n_streams"]:
            raise ValueError("the traffic's stream count differs from the configuration's")
        if traffic["advance_seconds"] != config["cadence_seconds"]:
            raise ValueError("the traffic's pushes differ from the configuration's cadence")
        streams = S.traffic(traffic, seed, self.device, self.sr)
        self.n_chunks = streams.chunks
        self.advance_s = streams.advance / self.sr
        self.host_src = streams.source.cpu().numpy()   # [chunks, streams, samples]
        self.host_cdn = streams.cdn.cpu().numpy()
        del streams
        self.mon = FleetMonitor(
            FeatureConfig(sample_rate=self.sr, window_size=int(config["window_size"]),
                          hop_size=int(config["hop_size"])),
            n_streams=int(config["n_streams"]), window_seconds=float(config["window_seconds"]),
            max_lag_seconds=float(config["max_lag_seconds"]),
            measure_batch=int(config["measure_batch"]), device=self.device)
        self.win_chunks = int(round(config["window_seconds"] / self.advance_s))
        for c in range(self.win_chunks):
            self._push(c)
        self.pushed = self.win_chunks
        self.calls: List[dict] = []   # every call: the chunk it pushed and its measurements
        self.call()  # the warm call: this shape's first run
        self.window_first = len(self.calls)

    def _push(self, chunk: int) -> None:
        self.mon.push_source_all(self.host_src[chunk])
        self.mon.push_cdn_all(self.host_cdn[chunk])

    def call(self):
        chunk = self.pushed % self.n_chunks
        self._push(chunk)
        self.pushed += 1
        res = self.mon.measure_all(refine=bool(self.cfg["refine"]))
        rows = [_row(m) for m in res]
        self.calls.append({"chunk": chunk, "pushed": self.pushed, "rows": rows})
        done = sum(r is not None for r in rows)
        return {"pairs": float(done)}, done != len(rows)

    def run_window(self, seconds: float) -> W.Window:
        return W.closed_loop(self.call, seconds)

    def run_calls(self, n: int) -> int:
        for _ in range(n):
            self.call()
        return n

    def sample(self, rng: np.random.Generator, n_calls: int, window_calls: int) -> List[dict]:
        """`n_calls` of the window's calls drawn from the seed, its last
        call among them; the program's state is freed."""
        first, last = self.window_first, self.window_first + window_calls - 1
        pool = np.arange(first, last)
        k = min(n_calls - 1, pool.size)
        picks = sorted(rng.choice(pool, size=k, replace=False).tolist()) + [last] if k else [last]
        self.mon = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return [self.calls[i] for i in picks]

    def inputs(self, call: dict):
        """The call's two windows on the device, rebuilt from the chunks."""
        last = call["chunk"]
        idx = [(last - self.win_chunks + 1 + i) % self.n_chunks for i in range(self.win_chunks)]
        src = torch.from_numpy(np.concatenate([self.host_src[i] for i in idx], axis=-1)).to(self.device)
        cdn = torch.from_numpy(np.concatenate([self.host_cdn[i] for i in idx], axis=-1)).to(self.device)
        return src, cdn

    def expected(self, reference, call: dict, lowp: bool) -> dict:
        src, cdn = self.inputs(call)
        out = reference.measure(src, cdn, self.cfg, lowp=lowp)
        out["time_s"] = call["pushed"] * self.advance_s
        return out

    def as_program(self, expected: dict) -> dict:
        """An expected result in the program's row form (the control)."""
        return {"rows": [{"latency_s": float(expected["latency_s"][i]),
                          "confidence": float(expected["confidence"][i]),
                          "similarity": float(expected["similarity"][i]),
                          "method": expected["method"][i], "time_s": expected["time_s"]}
                         for i in range(len(expected["method"]))]}

    def compare(self, reference, program: List[dict], expected: List[dict]) -> Dict[str, float]:
        return reference.compare(program, expected, self.sr, float(self.cfg["min_confidence"]))
