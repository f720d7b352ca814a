"""Multi-process runs of the port (`parallel/mesh.initialize_distributed`
and the global mesh), a twin of tests/test_multihost.py.

Two worker processes join one gloo process group through the port's
`initialize_distributed(..., device="cpu")`; each builds
`make_mesh(devices=[cpu] * 4)`, so the global mesh holds 8 entries,
rank-major. Each contributes its 4 local tones to a sharded
`stft(...).magnitude` through `shard_over_batch`, then an `all_reduce` of
the total energy; both run `sharded_top_k_matches` on the global mesh.
The parent holds the total to JAX's `stft` of the whole batch within 1e-5
relative, and both ranks' top-k to the single-process port's, equal. The
workers import only the port.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonido_sonar_tpu.ops.stft import stft as j_stft  # noqa: E402
from sonido_sonar_tpu_torch.parallel import mesh as TMS  # noqa: E402
from sonido_sonar_tpu_torch.parallel.matcher import sharded_top_k_matches  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SR, N, LOCAL = 8000, 2048, 4

_WORKER = r"""
import json, sys
pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import numpy as np
import torch
import torch.distributed as dist
from sonido_sonar_tpu_torch.parallel.mesh import (
    initialize_distributed, make_mesh, shard_over_batch,
)
from sonido_sonar_tpu_torch.parallel.matcher import sharded_top_k_matches
from sonido_sonar_tpu_torch.ops.stft import stft

initialize_distributed(f"127.0.0.1:{port}", num_processes=nproc, process_id=pid, device="cpu")
initialize_distributed(f"127.0.0.1:{port}", num_processes=nproc, process_id=pid, device="cpu")
assert dist.get_world_size() == nproc and dist.get_backend() == "gloo"
mesh = make_mesh(devices=[torch.device("cpu")] * 4)  # global: 4 entries a rank
assert mesh.size == 4 * nproc and mesh.distributed
assert mesh.local == tuple(range(4 * pid, 4 * pid + 4)), mesh.local

sr, n = 8000, 2048
local = np.stack([np.sin(2 * np.pi * (200.0 + 50.0 * (4 * pid + i)) * np.arange(n) / sr)
                  .astype(np.float32) for i in range(4)])
mags = shard_over_batch(
    lambda x: stft(x, sample_rate=sr, window_size=256, hop_size=128, device="cpu").magnitude,
    mesh,
)(local)
assert mags.shape[0] == 4
total = (mags.double() ** 2).sum().reshape(1)
dist.all_reduce(total)

corpus = np.random.default_rng(5).standard_normal((37, 44)).astype(np.float32)
corpus[[30, 12]] = corpus[4]
idx, scores = sharded_top_k_matches(corpus[4], corpus, k=9, mesh=mesh)
print("MULTIHOST_OK " + json.dumps({"pid": pid, "total": float(total), "idx": idx.tolist(),
                                    "scores": scores.tolist()}), flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_import_does_not_initialize_backend():
    """Importing the port and its mesh initializes neither CUDA nor a
    process group (initialize_distributed must come first)."""
    code = (
        "import torch, torch.distributed as dist\n"
        "import sonido_sonar_tpu_torch\n"
        "import sonido_sonar_tpu_torch.parallel.mesh\n"
        "assert not torch.cuda.is_initialized(), 'import initialized CUDA'\n"
        "assert not dist.is_initialized(), 'import initialized a process group'\n"
        "import sys; assert 'jax' not in sys.modules\n"
        "print('IMPORT_CLEAN')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "IMPORT_CLEAN" in out.stdout


def test_two_process_distributed_mesh(tmp_path):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen([sys.executable, str(script), str(pid), "2", str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                              text=True, cwd=tmp_path)
             for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    results = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        line = [ln for ln in out.splitlines() if ln.startswith("MULTIHOST_OK ")]
        assert line, out
        results.append(json.loads(line[0][len("MULTIHOST_OK "):]))
    assert [r["pid"] for r in results] == [0, 1]

    full = np.stack([np.sin(2 * np.pi * (200.0 + 50.0 * j) * np.arange(N) / SR)
                     .astype(np.float32) for j in range(2 * LOCAL)])
    want = float(np.sum(np.asarray(
        j_stft(jnp.asarray(full), sample_rate=SR, window_size=256, hop_size=128).magnitude,
        dtype=np.float64) ** 2))
    for r in results:
        assert abs(r["total"] - want) / want < 1e-5, (r["total"], want)
    assert results[0]["total"] == results[1]["total"]

    corpus = np.random.default_rng(5).standard_normal((37, 44)).astype(np.float32)
    corpus[[30, 12]] = corpus[4]
    idx, scores = sharded_top_k_matches(corpus[4], corpus, k=9, mesh=None, device="cpu")
    assert idx[:3].tolist() == [4, 12, 30]
    for r in results:
        assert r["idx"] == idx.tolist()
        np.testing.assert_allclose(r["scores"], scores, atol=1e-6, rtol=0)
    assert results[0]["scores"] == results[1]["scores"]


def test_initialize_distributed_noop_and_idempotent():
    """No coordinator and no process count: a no-op. Once a group exists,
    a repeated call is a no-op (a one-rank gloo group here)."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    TMS.initialize_distributed()
    assert not dist.is_initialized()
    TMS.initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu")
    try:
        assert dist.is_initialized() and dist.get_world_size() == 1
        TMS.initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu")
        mesh = TMS.make_mesh(devices=[torch.device("cpu")] * 2)
        assert mesh.size == 2 and mesh.local == (0, 1) and mesh.distributed
        # the one-rank group's all-gather merge gives the ranking without it
        corpus = np.random.default_rng(6).standard_normal((11, 44)).astype(np.float32)
        got = sharded_top_k_matches(corpus[3], corpus, k=4, mesh=mesh)
        want = sharded_top_k_matches(corpus[3], corpus, k=4, mesh=None, device="cpu")
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)
    finally:
        dist.destroy_process_group()


def test_initialize_distributed_raises(monkeypatch):
    """Every other failure raises instead of degrading to one process."""
    with pytest.raises(ValueError, match="process_id"):
        TMS.initialize_distributed("127.0.0.1:1", 2)
    with pytest.raises(ValueError, match="needs coordinator_address"):
        TMS.initialize_distributed(None, 2, 0)
    with pytest.raises(ValueError, match="device 'tpu'"):
        TMS.initialize_distributed("127.0.0.1:1", 2, 0, device="tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL needs a CUDA device"):
        TMS.initialize_distributed("127.0.0.1:1", 2, 0)
