"""The port's examples (`sonido_sonar_tpu_torch/examples/`) driven through
their own `main(device="cpu")` on synthesized inputs, with the
assertions of `tests/test_examples.py`; `parallel/pipeline.run_stream`
(order, the in-flight bound, outputs against blocking calls); and
`utils/metrics.profiler_trace` writing a trace on the CPU."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from sonido_sonar_tpu_torch.examples import batch_monitor, cdn_latency, corpus_search  # noqa: E402
from sonido_sonar_tpu_torch.io.decode import write_wav  # noqa: E402
from sonido_sonar_tpu_torch.io.synth import harmonic_tone, shift_signal, white_noise  # noqa: E402
from sonido_sonar_tpu_torch.models import FingerprintModel  # noqa: E402
from sonido_sonar_tpu_torch.parallel.pipeline import run_stream  # noqa: E402
from sonido_sonar_tpu_torch.utils import profiler_trace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _write_pair(tmp_path, seconds=4.0, sr=22050, lag_s=0.25):
    rng = np.random.default_rng(7)
    base = np.asarray(harmonic_tone(220.0, seconds, sr) + white_noise(seconds, sr, 0.05, seed=3))
    env = np.interp(np.arange(len(base)), np.linspace(0, len(base), int(6 * seconds)),
                    rng.uniform(0.1, 1.0, int(6 * seconds)))
    src = (base * env).astype(np.float32)
    cdn = shift_signal(src, int(lag_s * sr), noise=0.02, gain=0.9)
    src_path, cdn_path = str(tmp_path / "src.wav"), str(tmp_path / "cdn.wav")
    write_wav(src_path, src, sr)
    write_wav(cdn_path, cdn, sr)
    return src_path, cdn_path, sr


def test_cdn_latency_example(tmp_path, capsys):
    src_path, cdn_path, _ = _write_pair(tmp_path)
    res = cdn_latency.main(src_path, cdn_path, max_lag=1.5, device="cpu")
    out = capsys.readouterr().out
    assert "latency" in out and "confidence" in out
    line = [l for l in out.splitlines() if l.startswith("latency")][0]
    ms = float(line.split(":")[1].strip().split(" ")[0])
    assert abs(ms - 250.0) < 6.0  # within one hop
    assert sorted(res["ms"]) == ["alignment", "decode", "fingerprints", "refine"]
    assert res["latency_s"] * 1000 == pytest.approx(ms, abs=0.01)


def test_corpus_search_example(tmp_path, capsys):
    sr = 22050
    corpus_dir = tmp_path / "corpus"
    corpus_dir.mkdir()
    rng = np.random.default_rng(11)
    target = None
    for i, f0 in enumerate([180.0, 261.6, 392.0]):
        # rich slow-decay harmonic stacks, so music pre-emphasis leaves
        # them voiced (tests/test_examples.py says why)
        pcm = np.asarray(harmonic_tone(f0, 3.0, sr, num_harmonics=12, decay=0.95)
                         + white_noise(3.0, sr, 0.01, seed=20 + i)).astype(np.float32)
        pcm *= np.interp(np.arange(len(pcm)), np.linspace(0, len(pcm), 18),
                         rng.uniform(0.2, 1.0, 18)).astype(np.float32)
        write_wav(str(corpus_dir / f"clip{i}.wav"), pcm, sr)
        if i == 1:
            target = pcm
    query = (target + 0.01 * rng.standard_normal(len(target))).astype(np.float32)
    qpath = str(tmp_path / "query.wav")
    write_wav(qpath, query, sr)

    matches = corpus_search.main(qpath, str(corpus_dir), k=3, device="cpu")
    out = capsys.readouterr().out
    assert "top" in out
    first = [l for l in out.splitlines() if l.strip().startswith("#1")][0]
    assert "clip1.wav" in first
    assert matches[0].fingerprint.stream_url.endswith("clip1.wav")


def test_batch_monitor_example(capsys):
    res = batch_monitor.main(n_pairs=2, seconds=3.0, device="cpu")
    out = capsys.readouterr().out
    assert "exact" in out.lower() or "pairs" in out.lower()
    assert f"exact-sample recovery: {res['exact']}/2" in out


def test_examples_run_as_modules(tmp_path):
    """`python -m sonido_sonar_tpu_torch.examples.<name>` parses its
    arguments as the JAX scripts do (here up to the card it asks for)."""
    src_path, cdn_path, _ = _write_pair(tmp_path, seconds=2.0)
    proc = subprocess.run(
        [sys.executable, "-m", "sonido_sonar_tpu_torch.examples.cdn_latency", src_path,
         cdn_path, "0.5"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        assert proc.returncode == 0, proc.stderr[-2000:]
    else:  # the entry points default to the card; this host has none
        assert proc.returncode != 0 and "CUDA" in proc.stderr, proc.stderr[-2000:]


# -- run_stream ---------------------------------------------------------------

def _batches(n, b=2, length=6000, seed=0):
    rng = np.random.default_rng(seed)
    return [(0.3 * rng.standard_normal((b, length))).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("drain_every", [0, 1, 2, 5])
def test_run_stream_order_and_in_flight_bound(drain_every):
    calls = []

    def step(x):
        calls.append(1)
        return x.sum(dim=-1)

    batches = _batches(7)
    seen = []
    for i, out in enumerate(run_stream(step, iter(batches), drain_every=drain_every,
                                       device="cpu")):
        assert len(calls) <= i + drain_every + 1  # steps started, at most this many ahead
        seen.append(out)
    assert len(seen) == len(batches) == len(calls)
    for out, b in zip(seen, batches):
        torch.testing.assert_close(out, torch.from_numpy(b).sum(dim=-1), rtol=0, atol=0)


def test_run_stream_matches_blocking_calls():
    """FingerprintModel over a stream equals blocking calls, in order;
    tensor batches stay on their device."""
    model = FingerprintModel(device="cpu")
    batches = _batches(4, b=2, length=8192, seed=3)
    streamed = list(run_stream(model, batches, drain_every=2, device="cpu"))
    tensors = list(run_stream(model, [torch.from_numpy(b) for b in batches], drain_every=1))
    for got, again, b in zip(streamed, tensors, batches):
        want = model(torch.from_numpy(b))
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]) and torch.equal(again[k], want[k]), k


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    model = FingerprintModel(device="cpu")
    with profiler_trace(str(tmp_path / "trace")):
        model(torch.from_numpy(_batches(1, b=1, length=4096)[0]))
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::matmul" in e.get("name", "") for e in events)
