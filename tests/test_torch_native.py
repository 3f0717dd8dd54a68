"""The port's native host library (pixie_tpu_torch/native/build.py) against
the reference's (pixie_tpu/native/build.py).

  * the library builds with g++ into pixie_tpu_torch/_build/ and never
    touches the repo-root native/ directory;
  * two processes building at once get one loadable library;
  * a failed build is recorded (build_error), PIXIE_TPU_NO_NATIVE switches
    the library off;
  * the dictionary's native index gives the reference's codes for the same
    writes, non-ASCII strings included;
  * the native join's pairs equal the reference's `_native_join`.

`reference_native` (imported by the other port tests that hold a reference
native route) makes sure the reference has loaded native/libpixie_native.so
before a test compares against it: the reference links that file in place,
so a process can dlopen it half written and then keeps its Python fallback.
"""
import fcntl
import os
import pathlib
import subprocess
import sys
import time
import zlib

import numpy as np
import pytest

from pixie_tpu.ops import join_device as ref_jd
from pixie_tpu.table.dictionary import Dictionary as RefDictionary

from pixie_tpu_torch.native import build
from pixie_tpu_torch.ops import join_device as jd
from pixie_tpu_torch.table.dictionary import Dictionary

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "pixie_tpu_torch"


def _settled(path: pathlib.Path, quiet_s: float = 1.0, limit_s: float = 300.0):
    """Wait until `path` (present or not) has not changed for `quiet_s`."""
    def sig():
        try:
            st = path.stat()
            return st.st_size, st.st_mtime_ns
        except FileNotFoundError:
            return None

    last, since, end = sig(), time.monotonic(), time.monotonic() + limit_s
    while time.monotonic() < end:
        time.sleep(0.2)
        now = sig()
        if now != last:
            last, since = now, time.monotonic()
        elif time.monotonic() - since >= quiet_s:
            return


def _reload_reference():
    from pixie_tpu.native import build as ref_build
    with ref_build._lock:
        ref_build._lib, ref_build._tried = None, False
    return ref_build.load_native()


def _fresh(ref_build) -> bool:
    """The library is there and no older than its sources (the reference's
    own test for a rebuild)."""
    so = ref_build._SO_PATH
    srcs = list(ref_build._SRC_DIR.glob("*.cc"))
    return so.exists() and so.stat().st_mtime >= max(s.stat().st_mtime for s in srcs)


def _build_reference_atomically(ref_build, force: bool) -> str | None:
    """The reference's own g++ command into a temporary file in native/,
    renamed into place, one process at a time (a lock on the directory).
    Returns why the build failed, or None."""
    src_dir, so = ref_build._SRC_DIR, ref_build._SO_PATH
    fd = os.open(src_dir, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        _settled(so)
        if not force and _fresh(ref_build):
            return None  # another process finished it while this one waited
        tmp = src_dir / f".{so.name}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
               "-o", str(tmp), *[str(s) for s in sorted(src_dir.glob("*.cc"))]]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
            os.replace(tmp, so)
        except subprocess.CalledProcessError as e:
            return e.stderr.decode(errors="replace")[-2000:]
        except (subprocess.SubprocessError, OSError) as e:
            return repr(e)
        finally:
            tmp.unlink(missing_ok=True)
        return None
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


def ensure_reference_native():
    """The reference's native library, loaded; fails (never skips) with
    the reason when it cannot load.  The library is made fresh before the
    reference is asked to load it, so its in-place build never runs here."""
    from pixie_tpu.native import build as ref_build
    if ref_build._lib is not None:
        return ref_build._lib
    if ref_build._no_native():
        pytest.fail("the reference's native library is switched off "
                    "(PIXIE_TPU_NO_NATIVE)")
    _settled(ref_build._SO_PATH)
    why = None if _fresh(ref_build) else _build_reference_atomically(ref_build, force=False)
    lib = None if why else _reload_reference()
    if lib is None and why is None:  # there, but it does not load: rebuild it
        why = _build_reference_atomically(ref_build, force=True)
        lib = None if why else _reload_reference()
    if lib is None:
        pytest.fail(f"the reference's native library does not load: {why or 'dlopen failed'}")
    ref_jd.reset_gate_for_testing()  # its cached decision may predate the load
    return lib


@pytest.fixture
def reference_native():
    return ensure_reference_native()


pytestmark = pytest.mark.usefixtures("reference_native")


def _listing(d: pathlib.Path) -> dict:
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns) for p in sorted(d.iterdir())}


def test_library_builds_into_the_port_build_dir(tmp_path):
    before = _listing(ROOT / "native")
    assert build.load_native() is not None and build.build_error() is None
    assert build.library_path().parent == PKG / "_build"
    assert build.library_path().is_file()
    assert build.SRC_DIR == PKG / "native"
    # a fresh build elsewhere reads the port's sources only
    path = build.build_library(tmp_path)
    assert path.parent == tmp_path and path.name == build.library_path().name
    assert _listing(ROOT / "native") == before


_BUILD_AND_LOAD = (
    "import ctypes, pathlib, sys\n"
    "from pixie_tpu_torch.native import build\n"
    "p = build.build_library(pathlib.Path(sys.argv[1]))\n"
    "lib = ctypes.CDLL(str(p))\n"
    "print(p.name, hasattr(lib, 'px_wholeplan_run'))\n"
)


def test_two_processes_building_at_once_get_one_loadable_library(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_LOAD, str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _o, e in outs]
    names = {o.split()[0] for o, _e in outs}
    assert names == {build.library_path().name}
    assert all(o.split()[1] == "True" for o, _e in outs)
    assert [p.name for p in tmp_path.iterdir()] == [build.library_path().name]


def test_failed_build_is_recorded(tmp_path):
    code = (
        "import pathlib, sys\n"
        "from pixie_tpu_torch.native import build\n"
        "build.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
        "assert build.load_native() is None\n"
        "print(build.build_error())\n"
    )
    env = dict(os.environ, PATH=str(tmp_path / "bin"))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "b")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert "g++" in out.stdout


def test_no_native_switch_turns_the_library_off():
    code = (
        "import numpy as np\n"
        "from pixie_tpu_torch.native import build\n"
        "from pixie_tpu_torch.table.dictionary import Dictionary\n"
        "assert build.load_native() is None and build.build_error() is None\n"
        "print(Dictionary().encode(np.array(['b', 'a', 'b'])).tolist())\n"
    )
    env = dict(os.environ, PIXIE_TPU_NO_NATIVE="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[0, 1, 0]"


WRITES = {
    "ascii": [["svc-3", "svc-1", "svc-3", "svc-2"], ["svc-2", "svc-9", "svc-1"]],
    "non_ascii": [["café", "naïve", "日本語", "café", "Ωmega"], ["Ωmega", "😀", "naïve", "zz"]],
    "empty_and_wide": [["", "a" * 300, "", "b"], ["a" * 300, "c" * 7]],
    "mixed_lengths": [["a", "ab", "abc", "a"], ["abcd", "ab", "é", "éé"]],
}


@pytest.mark.parametrize("case", sorted(WRITES))
def test_dictionary_codes_equal_the_reference(case):
    """Batches of numpy 'U' arrays (the native route) interleaved with
    single `code()` inserts and a list batch (the numpy route): the same
    codes and values in the same order as the reference's."""
    def write(d):
        out = []
        for i, batch in enumerate(WRITES[case]):
            out.append(d.encode(np.array(batch)).tolist())
            out.append(d.code(f"single-{i}"))
            out.append(d.encode(list(reversed(batch))).tolist())
        return out

    got, want = Dictionary(), RefDictionary()
    assert write(got) == write(want)
    assert got.values() == want.values()
    assert got._nd is not None  # the native index served the 'U' batches


def test_dictionary_large_batch_matches_the_reference():
    """A batch past the native index's multi-threaded probe threshold."""
    rng = np.random.default_rng(7)
    vals = np.array([f"pod-{i}-é" for i in range(5000)])[rng.integers(0, 5000, 300_000)]
    got, want = Dictionary(), RefDictionary()
    np.testing.assert_array_equal(got.encode(vals), want.encode(vals))
    assert got.values() == want.values()


JOIN_CASES = {
    "uniform": (1 << 14, 1 << 14, 1 << 12),
    "skewed": (1 << 12, 1 << 15, 16),
    "no_match": (1000, 1000, 0),
    "sentinels": (5000, 7000, 300),
}


def _join_codes(case):
    nb, npr, k = JOIN_CASES[case]
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    if k == 0:
        return np.arange(nb, dtype=np.int64), np.arange(npr, dtype=np.int64) + nb
    b = rng.integers(0, k, nb).astype(np.int64)
    p = rng.integers(0, k, npr).astype(np.int64)
    if case == "sentinels":
        b[::7] = -1
        p[::5] = -2
    return b, p


@pytest.mark.parametrize("case", sorted(JOIN_CASES))
def test_native_join_pairs_equal_the_reference(case):
    b, p = _join_codes(case)
    got = jd.native_join(b, p)
    want = ref_jd._native_join(b, p)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    bidx, pidx, bm, pm = jd.native_join_codes(b, p)
    assert np.all(b[bidx] == p[pidx])
    assert bm.sum() == np.isin(b, p).sum() and pm.sum() == np.isin(p, b).sum()


def _restore_reference(ref_build, saved):
    with ref_build._lock:
        ref_build._SRC_DIR, ref_build._SO_PATH, ref_build._lib, ref_build._tried = saved
    ref_jd.reset_gate_for_testing()


def test_reference_native_recovers_a_cached_failure():
    """A process whose reference cached a failed load (what loading a half
    written library leaves: `_lib` None, `_tried` set) keeps its Python
    fallback on its own; the fixture's repair loads the library again."""
    from pixie_tpu.native import build as ref_build

    assert ensure_reference_native() is not None
    saved = (ref_build._SRC_DIR, ref_build._SO_PATH, ref_build._lib, ref_build._tried)
    try:
        with ref_build._lock:
            ref_build._lib, ref_build._tried = None, True
        assert ref_build.load_native() is None
        assert ensure_reference_native() is not None and ref_build._lib is not None
    finally:
        if ref_build._lib is None:
            _restore_reference(ref_build, saved)


def test_reference_native_rebuilds_a_half_written_library(tmp_path):
    """A library cut off mid-write (fresh mtime, its first 64 bytes: dlopen
    refuses it cleanly, where a longer cut can fault the process) does not
    load; the repair rebuilds it with the reference's command into a
    temporary file renamed into place, and loads it.  Run on a copy of
    native/ (the reference module's paths pointed there), so the shared
    library other workers load is never touched."""
    import shutil

    from pixie_tpu.native import build as ref_build

    assert ensure_reference_native() is not None
    saved = (ref_build._SRC_DIR, ref_build._SO_PATH, ref_build._lib, ref_build._tried)
    for src in ref_build._SRC_DIR.glob("*.cc"):
        shutil.copy2(src, tmp_path / src.name)
    so = tmp_path / ref_build._SO_PATH.name
    whole = ref_build._SO_PATH.read_bytes()
    so.write_bytes(whole[:64])
    try:
        with ref_build._lock:
            ref_build._SRC_DIR, ref_build._SO_PATH = tmp_path, so
            ref_build._lib, ref_build._tried = None, False
        assert ref_build.load_native() is None  # the reference's own fallback
        with ref_build._lock:
            ref_build._lib, ref_build._tried = None, False
        lib = ensure_reference_native()
        assert lib is not None and hasattr(lib, "px_wholeplan_run")
        assert so.stat().st_size > 64
        assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
            [so.name] + [s.name for s in saved[0].glob("*.cc")])  # no temporary left
    finally:
        _restore_reference(ref_build, saved)
