"""Sanitizer runs over the port's native hot loops (pixie_tpu_torch/native).

The port's copies of the reference's harnesses
(pixie_tpu_torch/native/sanitize/*.cc, the reference's native/sanitize/)
build with g++ against the port's own native/*.cc into standalone binaries
(a sanitizer cannot ride inside the ctypes library a non-instrumented
Python loads), then run:

  * sanitize_main.cc — dictionary + stream_agg correctness under
    ASan+UBSan;
  * concurrent_main.cc — the pthread paths (the whole-plan batch-range
    pool, the radix join's thread pools, the dictionary's parallel probe)
    under ASan in quick mode here; the TSan build
    (`PX_NATIVE_SANITIZE=thread`, native/build.SANITIZER_ARGS) runs full
    size in the slow lane, as the reference's does.
"""
import os
import subprocess

import pytest

from pixie_tpu_torch.native import build
from pixie_tpu_torch.native.build import SANITIZER_ARGS

NATIVE = build.SRC_DIR
HARNESS = build.SANITIZE_DIR
_SAN_SRCS = [NATIVE / "dictionary.cc", NATIVE / "stream_agg.cc", HARNESS / "sanitize_main.cc"]
_CONCURRENT_SRCS = [NATIVE / "dictionary.cc", NATIVE / "join.cc", NATIVE / "wholeplan.cc",
                    HARNESS / "concurrent_main.cc"]


def _build(tmp_path_factory, name: str, srcs: list, mode: str) -> str:
    out = tmp_path_factory.mktemp("san") / name
    cmd = ["g++", "-std=c++17", "-g", "-O1", *SANITIZER_ARGS[mode],
           "-pthread", "-o", str(out), *[str(s) for s in srcs]]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        pytest.skip(f"sanitizer toolchain unavailable ({mode}): {r.stderr[-500:]}")
    return str(out)


def _san_env() -> dict:
    return {**os.environ,
            "ASAN_OPTIONS": "detect_leaks=1:abort_on_error=0",
            "UBSAN_OPTIONS": "print_stacktrace=1",
            "TSAN_OPTIONS": "halt_on_error=0:exitcode=66"}


def test_harnesses_are_the_ports_own_copies():
    """The harnesses and the sources they drive live in the port's package;
    the harness sources declare every native entry point they call."""
    assert HARNESS.parent == NATIVE
    for src in (*_SAN_SRCS, *_CONCURRENT_SRCS):
        assert src.is_file(), src
        assert "pixie_tpu_torch" in str(src)
    assert set(SANITIZER_ARGS) == {"address", "thread"}


@pytest.mark.parametrize("harness", ["sanitize_main", "concurrent_main"])
def test_native_code_clean_under_asan_ubsan(tmp_path_factory, harness):
    """ASan+UBSan over the dictionary and stream_agg loops, and the
    concurrent driver at its quick sizes: a heap overflow, UB or a leak in
    the port's native code fails here."""
    srcs, args = ((_SAN_SRCS, []) if harness == "sanitize_main"
                  else (_CONCURRENT_SRCS, ["quick"]))
    binary = _build(tmp_path_factory, f"px_torch_{harness}_asan", srcs, "address")
    r = subprocess.run([binary, *args], capture_output=True, text=True, timeout=300,
                       env=_san_env())
    assert r.returncode == 0, f"sanitizer failure:\n{r.stderr[-4000:]}"
    assert "all checks passed" in r.stdout


@pytest.mark.slow
def test_native_pthread_paths_clean_under_tsan(tmp_path_factory):
    """Slow lane: the full-size concurrent driver under -fsanitize=thread
    (PX_NATIVE_SANITIZE selects the mode; 'address' substitutes where the
    TSan runtime is unavailable)."""
    from pixie_tpu_torch import flags

    mode = str(flags.get("PX_NATIVE_SANITIZE") or "thread")
    if mode not in SANITIZER_ARGS:
        pytest.skip(f"unknown PX_NATIVE_SANITIZE mode {mode!r}")
    binary = _build(tmp_path_factory, f"px_torch_concurrent_{mode}", _CONCURRENT_SRCS, mode)
    r = subprocess.run([binary], capture_output=True, text=True, timeout=600, env=_san_env())
    assert r.returncode == 0, f"{mode} sanitizer failure:\n{r.stdout[-1000:]}\n{r.stderr[-4000:]}"
    assert "all checks passed" in r.stdout
