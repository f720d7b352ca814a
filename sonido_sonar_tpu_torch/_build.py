"""Build and load the port's CUDA kernels.

The sources under `csrc/` are compiled by nvcc for sm_90a, one nvcc
per source, all started together, then linked into one shared library
with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c csrc/<name>.cu -o _build/<hash>/<name>.o   # each
    nvcc -shared -o _build/libsonido_kernels_<hash>.so _build/<hash>/*.o

The build runs at first use, from this package's sources only, into
`_build/` beside this file (git-ignored), or into the directory that
`warmup.enable_persistent_cache` names (`use_build_dir`). The library's
name carries a hash of the sources, the headers they include
(`csrc/*.cuh`) and the flags, so an edited source or header is rebuilt
and a stale library is never loaded. Processes that start at once build
under an exclusive `flock` on the build directory: one runs nvcc, the
others wait and load its library. Nothing falls back: a missing nvcc or
a failed build raises `KernelError`.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()` after the launch; `call` raises `KernelError` on a
nonzero code. Code that degrades on bad data (the alignment handlers)
re-raises `KernelError`, so a kernel fault is never taken for a data
error.
"""

from __future__ import annotations

import ctypes
import fcntl
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
SOURCES = (
    "csrc/stft.cu", "csrc/yin.cu", "csrc/onsets.cu", "csrc/dtw.cu", "csrc/contrast.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures: every pointer and the stream as c_void_p (a plain int
# would be cut to 32 bits), ints as c_int (long long as c_longlong),
# floats as c_float
_SIGNATURES = {
    # sig, window, twiddle, mag, aux, batch, n, frames, window, hop, pre_emph, stream
    "sonido_stft_aux": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # sig, window, twiddle, mag, aux, feat, row_ptr, entries, freq_logf,
    # batch, n, frames, window, hop, pre_emph, stream
    "sonido_stft_features": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # window, hop, features, smem bytes (out), blocks per SM (out)
    "sonido_stft_occupancy": (_I, _I, _I, _P, _P),
    # sig, twiddle, pitch, conf, amp (nullable), batch, n, frames, window,
    # hop, pre_emph, sample_rate, min_freq, max_freq, threshold, stream
    "sonido_yin_pitch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _P),
    # sig, twiddle, d, batch, n, frames, window, hop, stream
    "sonido_yin_difference": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # window, hop, rows (K3), smem bytes (out), blocks per SM (out)
    "sonido_yin_occupancy": (_I, _I, _I, _P, _P),
    # mag, bands, lanes, peak, valley, frames, bins, bands, the keys a lane
    # of the plan needs (0: no plan, the general form), largest group, stream
    "sonido_contrast_band_means": (_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P),
    # the keys a lane needs, bins, registers, local bytes, smem bytes,
    # blocks per SM (the last four out)
    "sonido_contrast_occupancy": (_I, _I, _P, _P, _P, _P),
    # cand, kept, rows, frames, min_frames, stream
    "sonido_thin_onsets": (_P, _P, _I, _I, _I, _P),
    # registers, local bytes, smem bytes, blocks per SM (all out)
    "sonido_thin_onsets_occupancy": (_P, _P, _P, _P),
    # q, r, cost, batch, n, m, d, band, stream
    "sonido_dtw_fill_banded": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "sonido_dtw_local_distances": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # cost, batch, n, m, band, stream
    "sonido_dtw_fill_rows": (_P, _I, _I, _I, _I, _P),
    # cost, qs, rs, cs, length, batch, n, m, band, stream, misses (nullable)
    "sonido_dtw_backtrack_banded": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
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
    """16 hex digits over the flags, every source and every header."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(p.relative_to(_PKG).as_posix() for p in (_PKG / "csrc").glob("*.cuh"))
    for src in (*SOURCES, *headers):
        h.update(src.encode())
        h.update((_PKG / src).read_bytes())
    return h.hexdigest()[:16]


def nvcc_commands(nvcc: str, out: Path) -> tuple:
    """(one compile command per source, the link command) building the
    library `out`; the objects go to a directory beside it."""
    objs = out.with_suffix("")
    compiles = [
        [nvcc, *NVCC_FLAGS, "-c", str(_PKG / s), "-o", str(objs / (Path(s).stem + ".o"))]
        for s in SOURCES
    ]
    link = [nvcc, "-shared", "-o", str(out), *(c[-1] for c in compiles)]
    return compiles, link


def _run_nvcc(nvcc: str, out: Path) -> str:
    """Compile every source at once, then link; raise KernelError with
    nvcc's output on a failure. Returns the compilers' output."""
    compiles, link = nvcc_commands(nvcc, out)
    Path(compiles[0][-1]).parent.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in compiles]
    logs, failed = [], []
    for cmd, proc in zip(compiles, procs):
        log = proc.communicate()[0]
        logs.append(f"== {Path(cmd[cmd.index('-c') + 1]).name}\n{log}")
        if proc.returncode != 0:
            failed.append(proc.returncode)
    if not failed:
        res = subprocess.run(link, capture_output=True, text=True)
        logs.append(res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(res.returncode)
    if failed:
        raise KernelError(f"nvcc failed ({failed}):\n" + "\n".join(logs))
    return "\n".join(logs)


def library_path() -> Path:
    """Where this checkout's library is (or will be) built."""
    return BUILD_DIR / f"libsonido_kernels_{source_hash()}.so"


# build() calls that loaded a library already on disk instead of running
# nvcc (warmup.cache_hit_counter reads it)
loads_from_disk = 0


def use_build_dir(path) -> None:
    """Build and load the library under `path` from the next `build()`
    on (a library this process already loaded stays loaded)."""
    global BUILD_DIR
    BUILD_DIR = Path(path)
    build.cache_clear()


def _build_library(lib_path: Path):
    """Run nvcc into `lib_path` unless a process that held the lock
    before this one has; returns nvcc's wall seconds, or None when it
    found the library built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd = os.open(BUILD_DIR, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)  # released when fd closes
        if lib_path.is_file():
            return None
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        try:
            log = _run_nvcc(find_nvcc(), tmp)
        except KernelError:
            tmp.unlink(missing_ok=True)  # a failed link may leave part of a library
            raise
        finally:
            shutil.rmtree(tmp.with_suffix(""), ignore_errors=True)
        lib_path.with_suffix(".log").write_text(log)
        os.replace(tmp, lib_path)  # atomic: a reader never sees half a file
        return time.perf_counter() - t0
    finally:
        os.close(fd)


def _load(lib_path: Path):
    try:
        return ctypes.CDLL(str(lib_path))
    except OSError as e:
        raise KernelError(f"cannot load {lib_path}: {e}") from e


@functools.lru_cache(maxsize=1)
def build() -> tuple:
    """(ctypes library, BuildInfo); builds once per process (once per
    build directory, `use_build_dir`)."""
    global loads_from_disk
    lib_path = library_path()
    log_path = lib_path.with_suffix(".log")
    seconds = None if lib_path.is_file() else _build_library(lib_path)
    if seconds is None:
        loads_from_disk += 1
    lib = _load(lib_path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sonido_error_string.argtypes = (ctypes.c_int,)
    lib.sonido_error_string.restype = ctypes.c_char_p
    log = log_path.read_text() if log_path.is_file() else ""
    return lib, BuildInfo(lib_path, seconds or 0.0, log)


def call(name: str, *args) -> None:
    """Run C entry point `name`; raise if it reports a CUDA error."""
    lib = build()[0]
    code = getattr(lib, name)(*args)
    if code != 0:
        msg = lib.sonido_error_string(code).decode()
        raise KernelError(f"{name} failed with CUDA error {code}: {msg}")
