"""Build and load the port's CUDA kernels.

The sources under `csrc/` are compiled by nvcc for sm_90a into one
shared library with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/libsonido_kernels_<hash>.so csrc/*.cu

The build runs at first use, from this package's sources only, into
`_build/` beside this file (git-ignored). The library's name carries a
hash of the sources and flags, so an edited source is rebuilt and a
stale library is never loaded. Nothing falls back: a missing nvcc or a
failed build raises `KernelError`.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()` after the launch; `call` raises `KernelError` on a
nonzero code. Code that degrades on bad data (the alignment handlers)
re-raises `KernelError`, so a kernel fault is never taken for a data
error.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "_build"
SOURCES = ("csrc/stft.cu", "csrc/yin.cu", "csrc/onsets.cu", "csrc/dtw.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: every pointer and the stream as c_void_p (a plain int
# would be cut to 32 bits), ints as c_int, floats as c_float
_SIGNATURES = {
    # sig, window, twiddle, mag, aux, batch, n, frames, window, hop, pre_emph, stream
    "sonido_stft_aux": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # sig, pitch, conf, amp (nullable), batch, n, frames, window, hop,
    # pre_emph, sample_rate, min_freq, max_freq, threshold, stream
    "sonido_yin_pitch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _P),
    # cand, kept, rows, frames, min_frames, stream
    "sonido_thin_onsets": (_P, _P, _I, _I, _I, _P),
    # q, r, cost, batch, n, m, d, band, stream
    "sonido_dtw_fill_banded": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # cost, qs, rs, cs, length, batch, n, m, band, stream
    "sonido_dtw_backtrack_banded": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
}


class KernelError(RuntimeError):
    """A CUDA kernel could not be built, loaded or launched."""


@dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float      # nvcc wall time; 0.0 when the library was already built
    compiler_log: str   # nvcc/ptxas output (registers, shared memory, spills)


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "sonido_sonar_tpu_torch are built from csrc/ at first use"
        )
    return found


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update((_PKG / src).read_bytes())
    return h.hexdigest()[:16]


def nvcc_command(nvcc: str, out: Path) -> list:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *(str(_PKG / s) for s in SOURCES)]


@functools.lru_cache(maxsize=1)
def build() -> tuple:
    """(ctypes library, BuildInfo); builds once per process."""
    lib_path = BUILD_DIR / f"libsonido_kernels_{source_hash()}.so"
    log_path = lib_path.with_suffix(".log")
    seconds = 0.0
    if not lib_path.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        res = subprocess.run(
            nvcc_command(find_nvcc(), tmp), capture_output=True, text=True
        )
        seconds = time.perf_counter() - t0
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelError(
                f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
            )
        log_path.write_text(res.stdout + res.stderr)
        os.replace(tmp, lib_path)  # atomic: a concurrent build never sees half a file
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError as e:
        raise KernelError(f"cannot load {lib_path}: {e}") from e
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sonido_error_string.argtypes = (ctypes.c_int,)
    lib.sonido_error_string.restype = ctypes.c_char_p
    log = log_path.read_text() if log_path.is_file() else ""
    return lib, BuildInfo(lib_path, seconds, log)


def call(name: str, *args) -> None:
    """Run C entry point `name`; raise if it reports a CUDA error."""
    lib = build()[0]
    code = getattr(lib, name)(*args)
    if code != 0:
        msg = lib.sonido_error_string(code).decode()
        raise KernelError(f"{name} failed with CUDA error {code}: {msg}")
