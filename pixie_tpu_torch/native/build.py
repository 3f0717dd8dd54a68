"""Build and load the port's native host library (ctypes, no pybind11).

The C++ sources beside this file (`wholeplan.cc`, `stream_agg.cc`,
`join.cc`, `dictionary.cc`: the port's copies of the reference's host fast
paths) compile with g++ on first use into

    pixie_tpu_torch/_build/libpixie_native-<digest>.so

The digest covers the sources and the flags, so an edited source is rebuilt
and a stale library is never loaded.  The library is written to a temporary
path of this process and moved into place with os.replace, as
ops/_build.py places the CUDA libraries: several processes building at once
(test workers) each produce a whole file and the last rename wins, so every
loader sees one loadable library.  Nothing is written next to the sources.

Everything native-backed has a pure-Python fallback (the routes that need
the library decline, and the query runs on the card route), so a missing
toolchain degrades performance, never correctness.  PIXIE_TPU_NO_NATIVE
forces the fallback.  A build that fails without that switch is kept in
`build_error()`: the executor copies it into exec_stats["native_build_error"]
whenever a CPU route is decided, and chip_smoke.py fails on it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
import time
from typing import Optional

from pixie_tpu_torch import flags as _flags

_flags.define_str(
    "PIXIE_TPU_NO_NATIVE", "",
    "force the pure-Python fallbacks even when the g++ toolchain is "
    "available (perf A/B and toolchain-bug escape hatch).  A kill switch: "
    "ANY value except ''/0/false/no/off disables native.  Live: read at "
    "first load_native() use, not import", live=True)

_flags.define_str(
    "PX_NATIVE_SANITIZE", "",
    "sanitizer build mode for the native STANDALONE test harnesses "
    "(tests/test_torch_native_sanitize.py): 'address' = ASan+UBSan, "
    "'thread' = TSan over the concurrent pthread driver (the slow lane).  "
    "Sanitizers never apply to the ctypes .so — they need an instrumented "
    "host binary", live=True)

#: g++ flags per sanitizer mode (the harness tests compile with these)
SANITIZER_ARGS = {
    "address": ["-fsanitize=address,undefined", "-fno-omit-frame-pointer"],
    "thread": ["-fsanitize=thread", "-fno-omit-frame-pointer"],
}

SRC_DIR = pathlib.Path(__file__).resolve().parent
#: the standalone sanitizer harnesses (the port's copies of the reference's
#: native/sanitize/*.cc), built and run by tests/test_torch_native_sanitize.py
SANITIZE_DIR = SRC_DIR / "sanitize"
BUILD_DIR = SRC_DIR.parent / "_build"
SOURCES = ("dictionary.cc", "join.cc", "stream_agg.cc", "wholeplan.cc")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None
_tried = False
_error: Optional[str] = None
#: seconds the build took in this process (0.0 = an existing library)
build_seconds: Optional[float] = None


def _no_native() -> bool:
    # any non-empty value disables native unless it is an explicit falsy
    # spelling — a kill switch must not fail silently on a non-canonical
    # truthy value
    val = str(_flags.get("PIXIE_TPU_NO_NATIVE")).strip().lower()
    return bool(val) and val not in ("0", "false", "no", "off")


def digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(build_dir: Optional[pathlib.Path] = None) -> pathlib.Path:
    return pathlib.Path(build_dir or BUILD_DIR) / f"libpixie_native-{digest()}.so"


def build_library(build_dir: Optional[pathlib.Path] = None) -> pathlib.Path:
    """Compile the library into `build_dir` (default _build/) unless it is
    there already; → its path.  Raises RuntimeError with g++'s output when
    the build fails."""
    target = library_path(build_dir)
    if target.is_file():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), *[str(SRC_DIR / s) for s in SOURCES]]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (subprocess.SubprocessError, OSError) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ could not run: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ exit {proc.returncode}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return target


def build_error() -> Optional[str]:
    """Why the library is not loaded, when its build or load failed (None
    while it loads, before the first load_native(), and when
    PIXIE_TPU_NO_NATIVE switched it off)."""
    return _error


def load_native():
    """ctypes handle to the native library, or None (fallback mode)."""
    global _lib, _tried, _error, build_seconds
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if _no_native():
            return None
        t0 = time.perf_counter()
        existed = library_path().is_file()
        try:
            path = build_library()
            lib = ctypes.CDLL(str(path))
        except (RuntimeError, OSError) as e:
            _error = f"{type(e).__name__}: {e}"
            return None
        build_seconds = 0.0 if existed else time.perf_counter() - t0
        lib.px_dict_new.restype = ctypes.c_void_p
        lib.px_dict_free.argtypes = [ctypes.c_void_p]
        lib.px_dict_size.argtypes = [ctypes.c_void_p]
        lib.px_dict_size.restype = ctypes.c_int64
        lib.px_dict_encode_ucs4.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.px_dict_encode_ucs4.restype = ctypes.c_int64
        lib.px_dict_insert_ucs4.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.px_dict_insert_ucs4.restype = ctypes.c_int32
        # the whole-plan loop's arguments are passed as explicit ctypes
        # objects by codegen.py, so only its return type is declared
        lib.px_wholeplan_run.restype = ctypes.c_int64
        lib.px_join_run.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.px_join_run.restype = ctypes.c_void_p
        lib.px_join_fetch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.px_join_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib
