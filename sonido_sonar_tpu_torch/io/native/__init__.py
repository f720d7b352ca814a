"""Native (C++) host-side WAV ingest through ctypes (counterpart of
`sonido_sonar_tpu/io/native/__init__.py`).

`wavio.cpp` is built with `g++ -O3 -shared -fPIC` at first use into the
git-ignored `_build/` of this package (`_build.BUILD_DIR`), as
`libwavio_<hash>.so`, the hash over the source and the flags, so an
edited source is rebuilt and a stale library never loaded. The compiler
writes to a temporary name, which is `os.replace`d into place under an
exclusive `fcntl` lock, so processes that load it for the first time at
once (test workers, decode threads) all succeed and none sees half a
file.

`available()` is False where the library cannot be had; the decoder then
takes the stdlib WAV path. A missing compiler is logged at debug level; a
failed compile or load is logged as an error with the compiler's or the
loader's message.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from sonido_sonar_tpu_torch import _build
from sonido_sonar_tpu_torch.logging import get_global_logger

SOURCE = Path(__file__).resolve().parent / "wavio.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
BUILD_DIR = _build.BUILD_DIR

_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libwavio_{h.hexdigest()[:16]}.so"


def _build_library(path: Path) -> bool:
    """Build `path` unless another process has; True when it exists."""
    log = get_global_logger().with_component("io", "native")
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.parent / "libwavio.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if path.is_file():
            return True
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=120)
        except FileNotFoundError:
            log.debug("g++ not found; the stdlib WAV path is used")
            return False
        except subprocess.CalledProcessError as e:
            tmp.unlink(missing_ok=True)
            log.error("building the native WAV loader failed", cmd=" ".join(cmd),
                      stderr=e.stderr)
            return False
        except subprocess.TimeoutExpired:
            tmp.unlink(missing_ok=True)
            log.error("building the native WAV loader timed out", cmd=" ".join(cmd))
            return False
        os.replace(tmp, path)
        return True


@functools.lru_cache(maxsize=1)
def _load_once() -> Optional[ctypes.CDLL]:
    path = library_path()
    if not path.is_file() and not _build_library(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        get_global_logger().with_component("io", "native").error(
            "loading the native WAV loader failed", path=str(path), error=str(e))
        return None
    c_float_p = ctypes.POINTER(ctypes.c_float)
    lib.wavio_decode.restype = ctypes.c_int
    lib.wavio_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(c_float_p),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.wavio_bytes_to_f32.restype = ctypes.c_int
    lib.wavio_bytes_to_f32.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(c_float_p),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.wavio_resample_linear.restype = ctypes.c_int
    lib.wavio_resample_linear.argtypes = [
        c_float_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(c_float_p), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.wavio_encode16.restype = ctypes.c_int64
    lib.wavio_encode16.argtypes = [
        c_float_p, ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
    ]
    lib.wavio_free.restype = None
    lib.wavio_free.argtypes = [ctypes.c_void_p]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    with _lock:  # one build or load per process, whichever thread asks first
        return _load_once()


def available() -> bool:
    return _load() is not None


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native wavio unavailable")
    return lib


def _take_floats(lib, ptr, n: int) -> np.ndarray:
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy() if n else np.zeros(0, np.float32)
    lib.wavio_free(ptr)
    return arr


def decode_wav_bytes(data: bytes) -> Tuple[np.ndarray, int, int]:
    """-> (mono float32 PCM, sample_rate, source_channels); ValueError
    when the parser rejects the bytes."""
    lib = _lib()
    out = ctypes.POINTER(ctypes.c_float)()
    n, rate, ch = ctypes.c_int64(), ctypes.c_int32(), ctypes.c_int32()
    rc = lib.wavio_decode(data, len(data), ctypes.byref(out), ctypes.byref(n),
                          ctypes.byref(rate), ctypes.byref(ch))
    if rc != 0:
        raise ValueError(f"wavio_decode failed: {rc}")
    return _take_floats(lib, out, n.value), rate.value, ch.value


_FMT = {"f32le": 0, "f64le": 1, "s16le": 2}


def bytes_to_f32(data: bytes, fmt: str = "f32le") -> np.ndarray:
    lib = _lib()
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    rc = lib.wavio_bytes_to_f32(data, len(data), _FMT[fmt], ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"wavio_bytes_to_f32 failed: {rc}")
    return _take_floats(lib, out, n.value)


def resample_linear(x: np.ndarray, rate_in: int, rate_out: int) -> np.ndarray:
    lib = _lib()
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    rc = lib.wavio_resample_linear(x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x),
                                   rate_in, rate_out, ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"wavio_resample_linear failed: {rc}")
    return _take_floats(lib, out, n.value)


def encode_wav16(x: np.ndarray, rate: int) -> bytes:
    lib = _lib()
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = ctypes.POINTER(ctypes.c_uint8)()
    total = lib.wavio_encode16(x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x), rate,
                               ctypes.byref(out))
    if total < 0:
        raise ValueError(f"wavio_encode16 failed: {total}")
    data = bytes(np.ctypeslib.as_array(out, shape=(total,)))
    lib.wavio_free(out)
    return data
