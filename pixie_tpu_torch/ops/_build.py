"""Build and load the port's CUDA kernels.

Every kernel source `csrc/<name>.cu` is compiled on first use, on the machine
that holds the card, into its own shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<digest>.so csrc/<name>.cu

and loaded with ctypes.  The digest covers the sources and the flags, so an
edited kernel is rebuilt and a stale library is never loaded.  All sources
build at once, one nvcc process each.  There is no fallback: a missing
`nvcc` or a failed build raises KernelUnavailable, and a CUDA tensor never
reaches a plain version instead of its kernel.  (Without --use_fast_math on purpose:
it would turn logf into __logf and move values between sketch bins.)

Each kernel has a launch counter (`KERNELS[name].launches`, split by C entry
point in `.by_entry`); a wrapper adds one exactly where it launches that
kernel.  The counters, the build and the symbol table are safe to use from
several threads at once (LocalCluster runs its agents concurrently).
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

from pixie_tpu_torch.status import Internal, Unavailable

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: kernel name -> source file under csrc/
SOURCES = {
    "segment_reduce": "segment_reduce.cu",
    "loghist_update": "loghist_update.cu",
    "loghist_quantile": "loghist_quantile.cu",
    "compact": "compact.cu",
    "join": "join.cu",
    "resident": "resident.cu",
    "merge": "merge.cu",
    "kmeans": "kmeans.cu",
    "chain": "chain.cu",
    "gang": "gang.cu",
    "repartition": "repartition.cu",
    "pack": "pack.cu",
    "finalize": "finalize.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


class KernelUnavailable(Unavailable):
    """A kernel library could not be built or loaded."""


@dataclasses.dataclass
class Kernel:
    name: str
    #: launches since the last reset_launches()
    launches: int = 0
    #: the same launches split by C entry point
    by_entry: dict = dataclasses.field(default_factory=dict)

    def count(self, entry: str) -> None:
        """Record one launch of `entry` (called right after a launch)."""
        with _count_lock:
            self.launches += 1
            self.by_entry[entry] = self.by_entry.get(entry, 0) + 1
        for tally in getattr(_tallies, "stack", ()):
            tally[self.name] = tally.get(self.name, 0) + 1


KERNELS = {name: Kernel(name) for name in SOURCES}
_count_lock = threading.Lock()
#: per-thread launch tallies open on this thread (`launch_tally`)
_tallies = threading.local()


@contextlib.contextmanager
def launch_tally():
    """{kernel: launches} made on THIS thread while the block runs — one
    agent's share of the process-wide counts when several agents execute
    in one process (the executor launches on its calling thread)."""
    stack = getattr(_tallies, "stack", None)
    if stack is None:
        stack = _tallies.stack = []
    out: dict = {}
    stack.append(out)
    try:
        yield out
    finally:
        stack.remove(out)


def reset_launches() -> None:
    with _count_lock:
        for k in KERNELS.values():
            k.launches = 0
            k.by_entry.clear()


def find_nvcc() -> str:
    """Path of nvcc: PATH first, then $CUDA_HOME/bin, then the toolkit's
    default install prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cand = pathlib.Path(root) / "bin" / "nvcc"
            if cand.is_file() and os.access(cand, os.X_OK):
                return str(cand)
    raise KernelUnavailable(
        "nvcc not found (searched PATH, $CUDA_HOME/bin, $CUDA_PATH/bin and "
        "/usr/local/cuda/bin): the port's CUDA kernels cannot be built")


def _digest(source: str) -> str:
    h = hashlib.sha256()
    for part in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(part.name.encode())
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_funcs: dict[tuple[str, str], object] = {}
#: seconds each library took to compile in this process (0.0 = reused)
build_seconds: dict[str, float] = {}


def build_all() -> dict[str, float]:
    """Build (where needed) and load every kernel library; returns the
    seconds each build took.  The nvcc processes run concurrently."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return dict(build_seconds)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        targets = {name: BUILD_DIR / f"lib{name}-{_digest(src)}.so"
                   for name, src in SOURCES.items()}
        todo = [name for name, path in targets.items() if not path.is_file()]
        procs = {}
        if todo:
            nvcc = find_nvcc()
            for name in todo:
                tmp = targets[name].with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
                procs[name] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), tmp, time.perf_counter())
        failures = []
        for name, (proc, tmp, t0) in procs.items():
            log, _ = proc.communicate()
            build_seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                failures.append(f"{SOURCES[name]} (nvcc exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, targets[name])
        if failures:
            raise KernelUnavailable("kernel build failed: " + "\n".join(failures))
        for name, path in targets.items():
            build_seconds.setdefault(name, 0.0)
            try:
                _libs[name] = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelUnavailable(f"cannot load {path.name}: {e}") from e
            _libs[name].px_error_string.argtypes = [ctypes.c_int]
            _libs[name].px_error_string.restype = ctypes.c_char_p
        return dict(build_seconds)


def function(lib: str, symbol: str, argtypes: list):
    """The C entry point `symbol` of kernel library `lib`, with its argtypes
    declared (every entry point returns a cudaError_t as int)."""
    key = (lib, symbol)
    fn = _funcs.get(key)
    if fn is None:
        build_all()
        with _lock:
            fn = _funcs.get(key)
            if fn is None:
                fn = getattr(_libs[lib], symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _funcs[key] = fn
    return fn


def check(lib: str, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = _libs[lib].px_error_string(err).decode(errors="replace")
        raise Internal(f"{what}: CUDA error {err} ({msg})")


def call(index: int, fn, *args) -> int:
    """fn(*args) with CUDA device `index` current, under torch.cuda.device
    only when another device is current (that context costs microseconds a
    call on the launch path)."""
    if torch.cuda.current_device() == index:
        return fn(*args)
    with torch.cuda.device(index):
        return fn(*args)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raw_stream(index: int) -> int:
    """The current CUDA stream of device `index` as an integer handle,
    without building a torch.cuda.Stream (the launch paths that count host
    microseconds use it)."""
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if get is None:
        return torch.cuda.current_stream(index).cuda_stream
    return get(index)
