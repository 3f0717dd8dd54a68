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
"""
import os
import pathlib
import subprocess
import sys
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
