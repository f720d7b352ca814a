"""Traffic is deterministic from --seed, and has the shapes its files state."""

import numpy as np
import pytest
import torch

from benchmark.core import spec as S
from benchmark.traffic import monitor_streams, pcm_clips

SR = 8000


def _small_monitor(name):
    t = dict(S.read_json(S.BENCH / "traffic" / f"{name}.json"))
    t.update(streams=4, ring_seconds=6, advance_seconds=1,
             unrelated=[i for i in (1, 3) if t["unrelated"]])
    return t


@pytest.mark.parametrize("name", ["mixed-64", "clean-64"])
def test_monitor_streams_are_deterministic_and_lagged(name):
    t = _small_monitor(name)
    a = monitor_streams.make(t, 2**31 + 12345, "cpu", SR)
    b = monitor_streams.make(t, 2**31 + 12345, "cpu", SR)
    c = monitor_streams.make(t, 2**31 + 12346, "cpu", SR)
    assert torch.equal(a.source, b.source) and torch.equal(a.cdn, b.cdn)
    assert np.array_equal(a.lags_samples, b.lags_samples)
    assert not torch.equal(a.source, c.source)
    assert a.source.shape == (6, 4, SR)
    src = a.source.transpose(0, 1).reshape(4, -1)
    cdn = a.cdn.transpose(0, 1).reshape(4, -1)
    for i in range(4):
        if i in a.unrelated:
            assert a.lags_samples[i] == 0
            continue
        lag = int(a.lags_samples[i])
        assert int(0.1 * SR) <= lag <= int(3.0 * SR)
        assert torch.allclose(cdn[i], 0.9 * torch.roll(src[i], lag))
    assert a.unrelated == t["unrelated"]


@pytest.mark.parametrize("name", ["stream-30s", "resident-30s"])
def test_pcm_clips_are_deterministic(name):
    t = dict(S.read_json(S.BENCH / "traffic" / f"{name}.json"), batch=8, clip_seconds=0.5, distinct=2)
    a = pcm_clips.make(t, 2**31 + 99, "cpu", SR)
    b = pcm_clips.make(t, 2**31 + 99, "cpu", SR)
    c = pcm_clips.make(t, 5, "cpu", SR)
    assert len(a) == 2 and all(x.shape == (8, SR // 2) and x.dtype == torch.float32 for x in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert not torch.equal(a[0], a[1])
    # every fourth row noise of sigma 0.1, the others tones under 1.6
    noise = a[0][3::4]
    assert 0.08 < float(noise.std()) < 0.12
    assert float(a[0][0].abs().max()) < 2.0


def test_every_traffic_file_names_a_generator_file():
    for p in (S.BENCH / "traffic").glob("*.json"):
        kind = S.read_json(p)["kind"]
        assert callable(getattr(S.load_module("traffic", kind), "make", None)), p.name


def test_a_traffic_kind_is_found_by_its_file(monkeypatch, tmp_path):
    """A new kind is a new file `traffic/<kind>.py`; no file changes."""
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "ramp.py").write_text(
        "import torch\n\n\ndef make(t, seed, device, sample_rate):\n"
        "    return torch.arange(int(t['n']), device=device) + seed\n")
    monkeypatch.setattr(S, "BENCH", tmp_path)
    monkeypatch.delitem(__import__("sys").modules, "benchmark.traffic.ramp", raising=False)
    got = S.traffic({"kind": "ramp", "n": 3}, 5, "cpu", SR)
    assert got.tolist() == [5, 6, 7]
