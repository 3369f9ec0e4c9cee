"""ctypes bindings for the native host runtime `native/wavespec_rt.cpp`
(counterpart of `wavespec_tpu/runtime/native.py`).

The library is built on first use with the system g++ into
`wavespec_tpu_torch/_build/` (git-ignored), named by a hash of the source
and the flags as the CUDA kernels are (`kernels/_build.py`): an edited
source is rebuilt, an unchanged one loaded as it is, and nothing is ever
written under `native/`. Every entry point returns the reference's
ALGLIB_STATUS codes; `Status.raise_for` maps them to Python exceptions.
The runtime does host file IO and a host worker pool only: where no
compiler is available, `load()` returns None and `runtime.caches` and
`runtime.jobs` take their NumPy and thread-pool paths.
"""

from __future__ import annotations

import atexit
import ctypes
import enum
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG.parent / "native" / "wavespec_rt.cpp"
BUILD_DIR = _PKG / "_build"
FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed: str | None = None

JOB_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


class Status(enum.IntEnum):
    """`ALGLIB_STATUS_*` (`WaveCyclesBatchFetcher.mq5:14-22`)."""

    OK = 0
    BAD_ARGS = -1
    BACKEND_UNAVAILABLE = -2
    TIMEOUT = -3
    INTERNAL_ERROR = -4
    NOT_READY = -5
    NO_MEM = -6

    @staticmethod
    def raise_for(code: int, context: str = "") -> None:
        if code == Status.OK or code == Status.NOT_READY:
            return
        raise RuntimeError(f"wavespec_rt {Status(code).name} {context}".strip())


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"libwavespec_rt-{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """Compile into a temporary file beside `out`, then rename it, so that
    processes building at once never load a half-written library."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        cmd = ["g++", *FLAGS, "-o", tmp, str(SRC), "-lpthread"]
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load() -> ctypes.CDLL | None:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _load_failed is not None:
            return None
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.CalledProcessError) as exc:  # pragma: no cover
            _load_failed = str(exc)
            return None

        lib.ws_get_last_error.argtypes = [ctypes.c_char_p, ctypes.c_int32]
        lib.ws_get_last_error.restype = ctypes.c_int32
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int32)
        lib.ws_feed_cache_count.argtypes = [ctypes.c_char_p, ip]
        lib.ws_feed_cache_count.restype = ctypes.c_int32
        lib.ws_feed_cache_load.argtypes = [ctypes.c_char_p, dp, ctypes.c_int32, ip]
        lib.ws_feed_cache_load.restype = ctypes.c_int32
        lib.ws_feed_cache_save.argtypes = [ctypes.c_char_p, dp, ctypes.c_int32]
        lib.ws_feed_cache_save.restype = ctypes.c_int32
        lib.ws_cycle_cache_load.argtypes = [ctypes.c_char_p, dp, ctypes.c_int32, ip, ip]
        lib.ws_cycle_cache_load.restype = ctypes.c_int32
        lib.ws_cycle_cache_save.argtypes = [ctypes.c_char_p, dp, ctypes.c_int32]
        lib.ws_cycle_cache_save.restype = ctypes.c_int32
        lib.ws_init.argtypes = [ctypes.c_int32]
        lib.ws_init.restype = ctypes.c_int32
        lib.ws_shutdown.argtypes = []
        lib.ws_shutdown.restype = None
        lib.ws_submit_job.argtypes = [JOB_FN, ctypes.c_void_p, ip]
        lib.ws_submit_job.restype = ctypes.c_int32
        lib.ws_try_get_job.argtypes = [ctypes.c_int32, ip]
        lib.ws_try_get_job.restype = ctypes.c_int32
        lib.ws_free_job.argtypes = [ctypes.c_int32]
        lib.ws_free_job.restype = ctypes.c_int32
        lib.ws_pending_jobs.argtypes = []
        lib.ws_pending_jobs.restype = ctypes.c_int32

        # join the worker threads before interpreter teardown (blocked
        # threads being destructed would std::terminate the process)
        atexit.register(lib.ws_shutdown)
        _lib = lib
        return lib


def last_error() -> str:
    lib = load()
    if lib is None:
        return _load_failed or ""
    buf = ctypes.create_string_buffer(512)
    lib.ws_get_last_error(buf, 512)
    return buf.value.decode(errors="replace")


def available() -> bool:
    return load() is not None
