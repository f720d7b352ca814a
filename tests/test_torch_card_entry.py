"""The port's ingest layer and user entry points on the card, from WAV
files in a temporary directory: the native WAV loader against the stdlib
read, `examples.cdn_latency` and `examples.corpus_search`, the accuracy
sweep against the gates of tests/test_eval_gates.py, `run_stream`,
`examples.batch_monitor`, `utils.profiler_trace`, and `warmup`'s kernel
cache across fresh processes. Every case is marked `card` and skips
without a CUDA device. On the card:

    python3 -m pytest --noconftest -q -p no:cacheprovider -m card tests/test_torch_card_entry.py
"""

from __future__ import annotations

import concurrent.futures
import json
import multiprocessing
import os
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

import card_support as C
from card_support import FULL_B, HOP, SEED, SR, card, counted  # noqa: F401  (card: the session fixture)

pytestmark = pytest.mark.card

INGEST_FILES, INGEST_SECONDS = 64, 30      # mono 16-bit WAVs at SR
STEREO_FILES, STEREO_SR = 4, 48000        # stereo 16-bit WAVs, resampled on decode
WAV_ATOL = 1e-6                           # tests/test_native_io.py's native-vs-stdlib bound
QUERY_FILE = 17                           # the corpus query: this file plus noise
STREAM_BATCHES = 8                        # host batches of FULL_B x 30 s through run_stream
SLEEP_CYCLES = 200_000_000                # ~0.1 s at 1.98 GHz: longer than the host takes to stage a batch
TRACE_ROUNDS = 3                          # traces in this process, each held to the fresh one's


def stdlib_wav(path: str) -> tuple:
    """(mono float32 PCM, rate) read with the stdlib `wave` module alone,
    as tests/test_native_io.py reads its reference."""
    with wave.open(path, "rb") as w:
        ch, sr = w.getnchannels(), w.getframerate()
        x = np.frombuffer(w.readframes(w.getnframes()), dtype="<i2").astype(np.float32) / 32768.0
    return (x.reshape(-1, ch).mean(axis=1) if ch > 1 else x), sr


@pytest.fixture(scope="module")
def wavs(card, tmp_path_factory):
    """64 mono WAVs of 30 s at 44.1 kHz written with the port's write_wav
    (in a process pool: the speech generator is a Python loop) under
    `corpus/`, and 4 stereo 48 kHz WAVs written with the stdlib."""
    tmp = tmp_path_factory.mktemp("ingest")
    corpus = tmp / "corpus"
    corpus.mkdir()
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1), mp_context=multiprocessing.get_context("spawn")) as ex:
        mono = list(ex.map(C.write_ingest_clip, range(INGEST_FILES), [INGEST_SECONDS] * INGEST_FILES,
                           [str(corpus / f"clip{i:02d}.wav") for i in range(INGEST_FILES)]))
    stereo = []
    for j in range(STEREO_FILES):
        rng = np.random.default_rng(SEED + 300 + j)
        t = np.arange(STEREO_SR * INGEST_SECONDS) / STEREO_SR
        x = np.stack([0.4 * np.sin(2 * np.pi * (300.0 + 50 * j) * t), 0.2 * rng.standard_normal(len(t))], axis=1)
        p = str(tmp / f"stereo{j}.wav")
        with wave.open(p, "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(STEREO_SR)
            w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
        stereo.append(p)
    return mono, stereo


def test_ingest_native_and_stdlib_paths_match_the_stdlib_read(wavs, monkeypatch):
    """The native loader is built (g++); decode_files_parallel on the
    native path and on the decoder's stdlib path, every file's PCM within
    WAV_ATOL of the stdlib read (the 48 kHz files through
    _resample_polyphase)."""
    from sonido_sonar_tpu_torch.io import native
    from sonido_sonar_tpu_torch.io.decode import _resample_polyphase, decode_files_parallel

    assert native.available(), "the native WAV loader is not available (g++ build)"
    files = wavs[0] + wavs[1]
    audios = decode_files_parallel(files)
    monkeypatch.setattr(native, "available", lambda: False)
    stdlib_audios = decode_files_parallel(files)
    for p, a, s in zip(files, audios, stdlib_audios, strict=True):
        ref, sr = stdlib_wav(p)
        if sr != SR:
            ref = _resample_polyphase(ref, sr, SR)
        for got in (a, s):
            assert got is not None and got.sample_rate == SR and got.pcm.shape == ref.shape, p
            assert float(np.abs(got.pcm - ref).max()) <= WAV_ATOL, p


@pytest.mark.parametrize("label", ["speech", "music"])
def test_cdn_latency_within_one_hop(card, tmp_path, label):
    """examples.cdn_latency at full width: 60 s sources and CDN copies
    delayed by LATENCY_LAG, a 30 s budget; the first call and a warm one
    each within one hop of the lag, K1 launched."""
    from sonido_sonar_tpu_torch.examples import cdn_latency

    sp, cp = C.latency_pair(label, 60, tmp_path)
    for call in ("first", "warm"):
        out, launches = counted(lambda: cdn_latency.main(sp, cp, C.LATENCY_BUDGET, device=card.dev))
        assert abs(out["latency_s"] - C.LATENCY_LAG / SR) <= HOP / SR, f"{call}: {out['latency_s']}"
        assert launches["K1"] >= 1, launches


def test_cdn_latency_in_a_fresh_process(card, tmp_path):
    """`python -m sonido_sonar_tpu_torch.examples.cdn_latency`, as a user's
    first command (the kernel and WAV libraries already built)."""
    sp, cp = C.latency_pair("speech", 60, tmp_path)
    proc = subprocess.run([sys.executable, "-m", "sonido_sonar_tpu_torch.examples.cdn_latency", sp, cp,
                           str(C.LATENCY_BUDGET)], capture_output=True, text=True, timeout=600, cwd=C.ROOT)
    assert proc.returncode == 0 and "latency" in proc.stdout, proc.stderr[-3000:]


def test_corpus_search_ranks_the_query_file_first(card, wavs, tmp_path):
    """examples.corpus_search over the 64 files with a query of file 17
    plus noise (0.02): rank 1 is file 17, K1 launched for every file."""
    from sonido_sonar_tpu_torch.examples import corpus_search
    from sonido_sonar_tpu_torch.io.decode import write_wav

    rng = np.random.default_rng(SEED + 17)
    query = C.ingest_clip(QUERY_FILE, INGEST_SECONDS) + 0.02 * rng.standard_normal(INGEST_SECONDS * SR)
    qpath = str(tmp_path / "query.wav")
    write_wav(qpath, query.astype(np.float32), SR)
    mono = wavs[0]
    matches, launches = counted(lambda: corpus_search.main(qpath, str(Path(mono[0]).parent), k=5, device=card.dev))
    assert Path(matches[0].fingerprint.stream_url).name == Path(mono[QUERY_FILE]).name
    assert launches["K1"] >= len(mono), launches


def test_the_port_imports_neither_jax_nor_the_jax_package(card):
    """Every module of the port imported in a fresh process; neither `jax`
    nor `sonido_sonar_tpu` is imported then."""
    script = ("import importlib, pkgutil, sys\n"
              "import sonido_sonar_tpu_torch as p\n"
              "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
              "    importlib.import_module(m.name)\n"
              "print(sorted(k for k in ('jax', 'sonido_sonar_tpu') if k in sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=600, cwd=C.ROOT)
    assert proc.returncode == 0 and proc.stdout.strip().splitlines()[-1] == "[]", (proc.stdout, proc.stderr[-3000:])


# -- the accuracy sweep ------------------------------------------------------------

def _min_accept() -> float:
    from sonido_sonar_tpu_torch.config.config import ContentType, alignment_config_for_content

    return min(alignment_config_for_content(ct).min_confidence for ct in ContentType)


def test_accuracy_sweep_at_44k_meets_every_gate(card):
    """run_extended at 44.1 kHz, full: gates 1, 2 and 4 of
    tests/test_eval_gates.py (every default-path category within one hop,
    coarse and refined, median refined error within a hop, mean confidence
    at least the laxest accept threshold; the time-stretch errors below
    1e-3), and gate 3 per case (with verification forced off, a
    comb-ambiguous wrong answer arrives below every accept threshold);
    the chroma DTW on the DTW kernels."""
    from sonido_sonar_tpu_torch import eval_accuracy as EA

    min_accept = _min_accept()
    summary, launches = counted(lambda: EA.run_extended(SR, quick=False, device=card.dev))
    misses = []
    for cat, s in summary["categories"].items():
        if cat.endswith("_unverified"):
            continue
        if s["coarse_within_one_hop"] != 1.0 or s["refined_within_one_hop"] != 1.0:
            misses.append(f"{cat}: within one hop {s['coarse_within_one_hop']}, {s['refined_within_one_hop']}")
        if s["refined_err_ms_median"] > summary["hop_ms"]:
            misses.append(f"{cat}: median refined error {s['refined_err_ms_median']} ms")
        if s["mean_confidence"] < min_accept:
            misses.append(f"{cat}: mean confidence {s['mean_confidence']} < {min_accept}")
    ts = summary["time_stretch"]
    if not ts["max_abs_error"] < 1e-3:
        misses.append(f"time stretch max error {ts['max_abs_error']}")
    if ts["dtw_slope_max_abs_error"] is not None and not ts["dtw_slope_max_abs_error"] < 1e-3:
        misses.append(f"DTW-slope stretch max error {ts['dtw_slope_max_abs_error']}")
    ext = EA.sweep_extractor(SR, card.dev)
    hop_s = ext.config.hop_size / SR
    for cat, src, cdn, lag, verify in EA.extended_cases(SR, False):
        if cat == "music_bandlimited_unverified":
            feats, _ = EA.align_case(ext, src, cdn, SR, verify)
            if abs(feats.temporal_offset - lag / SR) > hop_s + 1e-6 and feats.offset_confidence >= min_accept:
                misses.append(f"{cat}: a wrong answer at confidence {feats.offset_confidence}")
    assert not misses, misses
    assert launches["fill"] >= 1 and launches["backtrack"] >= 1, launches


def test_accuracy_run_batched_coarse_offsets_equal_per_pair(card):
    from sonido_sonar_tpu_torch import eval_accuracy as EA

    assert EA.run(SR, quick=False, batched=True, device=card.dev)["batched"]["coarse_identical_to_per_pair"]


def test_accuracy_sweep_at_22k_card_against_cpu(card):
    """run_extended at 22.05 kHz, quick: equal per-category within-one-hop
    rates on the card and the CPU."""
    from sonido_sonar_tpu_torch import eval_accuracy as EA

    on_card = EA.run_extended(22050, quick=True, device=card.dev)["categories"]
    on_cpu = EA.run_extended(22050, quick=True, device="cpu")["categories"]
    assert list(on_card) == list(on_cpu)
    rates = ("coarse_within_one_hop", "refined_within_one_hop")
    assert not [c for c in on_cpu if any(on_card[c][r] != on_cpu[c][r] for r in rates)]


# -- run_stream, batch_monitor and profiler_trace ----------------------------------------

@pytest.fixture(scope="module")
def stream_batches(card):
    """STREAM_BATCHES distinct host batches of FULL_B x 30 s: one synthetic
    batch rolled by 0.1 s and scaled down 3 % a batch."""
    from sonido_sonar_tpu_torch.utils import parity

    base = parity.synth_pcm(FULL_B, C.N_FULL, SEED + 36, SR).numpy()
    return [np.roll(base, 4410 * k, axis=1) * np.float32(1.0 - 0.03 * k) for k in range(STREAM_BATCHES)]


@pytest.mark.parametrize("drain_every", [0, 1, 2, 3])
def test_run_stream_bit_equal_to_blocking_calls(card, stream_batches, drain_every):
    """models.FingerprintModel over 8 host batches of 128 x 30 s under
    run_stream and as blocking calls: the outputs bit-equal, in order; K1
    and K2 launched once a batch; each batch uploaded on the copy stream."""
    from sonido_sonar_tpu_torch.models import FingerprintModel
    from sonido_sonar_tpu_torch.parallel.pipeline import run_stream

    model = FingerprintModel(device=card.dev)
    want = [model(torch.from_numpy(b).to(card.dev)) for b in stream_batches]
    before = run_stream.copy_uploads
    got, launches = counted(lambda: list(run_stream(model, stream_batches, drain_every=drain_every,
                                                    device=card.dev)))
    assert run_stream.copy_uploads - before == STREAM_BATCHES
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w) and all(torch.equal(g[key], w[key]) for key in w), f"step {k}"
    assert launches["K1"] == STREAM_BATCHES and launches["K2"] == STREAM_BATCHES, launches


def _sleep_then_read(x):
    torch.cuda._sleep(SLEEP_CYCLES)
    return x.clone()


@pytest.mark.parametrize("step", [pytest.param(_sleep_then_read, id="sleep_then_read"),
                                  pytest.param(torch.clone, id="read_at_once")])
def test_run_stream_steps_read_their_own_upload(card, stream_batches, step):
    """Two steps that show the copy stream's hazards, each bit-equal to
    blocking calls over the 8 host batches under run_stream(drain_every=2).
    A step that sleeps on the compute stream before it reads its batch
    reads a later batch if the batch's memory went to a later upload while
    the step still held it; a step that reads its batch at once reads a
    partial upload if it does not wait for the copy."""
    from sonido_sonar_tpu_torch.parallel.pipeline import run_stream

    got = list(run_stream(step, stream_batches, drain_every=2, device=card.dev))
    assert len(got) == STREAM_BATCHES
    for k, (g, b) in enumerate(zip(got, stream_batches)):
        assert torch.equal(g, step(torch.from_numpy(b).to(card.dev))), f"step {k}"


@pytest.mark.parametrize("n_pairs,seconds", [(8, 12.0), (64, 60.0)])
def test_batch_monitor_recovers_the_exact_sample(card, n_pairs, seconds):
    from sonido_sonar_tpu_torch.examples import batch_monitor

    out = batch_monitor.main(n_pairs, seconds, device=card.dev)
    assert out["exact"] == n_pairs, out


TRACE_STEP = """
import json, sys, torch
sys.path.insert(0, sys.argv[1])
import card_support as C
from sonido_sonar_tpu_torch.models import FingerprintModel
from sonido_sonar_tpu_torch.utils import parity
torch.backends.cuda.matmul.allow_tf32 = False
x = parity.synth_pcm(C.FULL_B, C.N_FULL, C.SEED + 36, C.SR, "cuda")
model = FingerprintModel(device="cuda")
model(x)
print(json.dumps(C.traced_step(model, x)))
"""


def test_profiler_trace_records_every_launch(card):
    """One main-path step under profiler_trace in a fresh process, as a
    profiling run is made, and the same step 3 times in this process,
    after the earlier cases: each trace holds a kernel record for each of
    its launch calls, as many calls as the fresh process's, K1's kernel
    named and launched once."""
    from sonido_sonar_tpu_torch.models import FingerprintModel
    from sonido_sonar_tpu_torch.utils import parity

    proc = subprocess.run([sys.executable, "-c", TRACE_STEP, str(C.ROOT / "tests")],
                          capture_output=True, text=True, timeout=600, cwd=C.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    fresh = json.loads(proc.stdout.strip().splitlines()[-1])
    x = parity.synth_pcm(FULL_B, C.N_FULL, SEED + 36, SR, card.dev)
    model = FingerprintModel(device=card.dev)
    model(x)
    for where, got in [("a fresh process", fresh)] + [
            (f"this process, round {i}", C.traced_step(model, x)) for i in range(TRACE_ROUNDS)]:
        assert got["names_k1"] and got["kernels"] == got["launch_calls"] == fresh["launch_calls"], (where, got)
        assert got["launches"]["K1"] == 1, (where, got)


# -- warmup's kernel cache across fresh processes ------------------------------------------

WARM_FIRST = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.backends.cuda.matmul.allow_tf32 = False
import card_support as C
from sonido_sonar_tpu_torch import _build
from sonido_sonar_tpu_torch.warmup import cache_hit_counter, warmup
hits = cache_hit_counter()
warmup(cache_dir=sys.argv[2], batch_sizes=(C.FULL_B,), clip_seconds=(C.FULL_SECONDS,),
       components=("fingerprint", "alignment", "search"), alignment_pairs=(1, 32), corpus_sizes=(C.CORPUS_ROWS,))
info = _build.build()[1]
print(json.dumps({"hits": hits(), "nvcc_s": info.seconds, "library": str(info.path)}))
"""

WARM_AGAIN = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.backends.cuda.matmul.allow_tf32 = False
import card_support as C
from sonido_sonar_tpu_torch import _build
from sonido_sonar_tpu_torch.examples import cdn_latency
from sonido_sonar_tpu_torch.warmup import cache_hit_counter, enable_persistent_cache, warmup
hits = cache_hit_counter()
enable_persistent_cache(sys.argv[2])
info = _build.build()[1]
if sys.argv[3] == "warm":
    warmup(batch_sizes=(1,), clip_seconds=(60,), components=("fingerprint", "alignment"), alignment_pairs=(1,),
           window_seconds=60, max_lag_seconds=C.LATENCY_BUDGET)
for _ in range(2):
    out = cdn_latency.main(sys.argv[4], sys.argv[5], C.LATENCY_BUDGET)
print(json.dumps({"hits": hits(), "nvcc_s": info.seconds, "library": str(info.path), "latency_s": out["latency_s"]}))
"""


def test_warmup_cache_across_fresh_processes(card, tmp_path):
    """Three fresh processes sharing one cache_dir. The first runs
    warmup(cache_dir=...) at B=128 x 30 s, alignment pairs (1, 32) and a
    262,144-row corpus: nvcc builds the library there, no cache hit. The
    second loads it without nvcc (one hit), warms the cdn_latency shape
    and runs two examples.cdn_latency calls on a 60 s speech pair; the
    third loads it the same way and runs the calls without a warm-up.
    Each later call's latency within one hop."""
    cache = str(tmp_path / "kernels")
    sp, cp = C.latency_pair("speech", 60, tmp_path)
    tests = str(C.ROOT / "tests")
    res = {}
    for name, script, args in (("first", WARM_FIRST, [cache]), ("warmed", WARM_AGAIN, [cache, "warm", sp, cp]),
                               ("cold", WARM_AGAIN, [cache, "cold", sp, cp])):
        proc = subprocess.run([sys.executable, "-c", script, tests, *args], capture_output=True, text=True,
                              timeout=900, cwd=C.ROOT)
        assert proc.returncode == 0, f"the {name} process: {proc.stderr[-3000:]}"
        res[name] = json.loads(proc.stdout.strip().splitlines()[-1])
    first = res["first"]
    assert first["hits"] == 0 and first["nvcc_s"] > 0 and Path(first["library"]).parent.name == "kernels", first
    for name in ("warmed", "cold"):
        r = res[name]
        assert r["hits"] == 1 and r["nvcc_s"] == 0.0 and r["library"] == first["library"], (name, r)
        assert abs(r["latency_s"] - C.LATENCY_LAG / SR) <= HOP / SR, (name, r)
