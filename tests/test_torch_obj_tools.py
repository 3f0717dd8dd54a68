"""The port's object-file tools (obj_tools/: ElfReader, NativeSymbolizer,
DwarfReader) and the perf profiler connector (collect/perf_profiler.py).

The cases of tests/test_obj_tools.py (ELF reading and native
symbolization), tests/test_probe_codegen.py's DwarfReader and
tests/test_perf_profiler.py that run on this box, on the port; each
reader's answers equal the reference's on the same binary, exactly.  The
pxtrace validation cases wait for the port's pxtrace compiler."""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys
import textwrap
import threading
import time

import pytest

import pixie_tpu  # noqa: F401  (JAX first: x64 on)
from pixie_tpu.obj_tools import ElfReader as RefElfReader
from pixie_tpu.obj_tools.dwarf_reader import DwarfReader as RefDwarfReader

from pixie_tpu_torch.collect.core import Collector
from pixie_tpu_torch.collect.perf_profiler import PerfProfilerConnector, fold_stack
from pixie_tpu_torch.compiler import compile_pxl
from pixie_tpu_torch.engine import execute_plan
from pixie_tpu_torch.obj_tools import ElfReader, NativeSymbolizer
from pixie_tpu_torch.obj_tools.dwarf_reader import DwarfReader


@pytest.fixture(scope="module")
def small_binary(tmp_path_factory):
    """A tiny unstripped binary with known symbols and debug info."""
    d = tmp_path_factory.mktemp("elf")
    src = d / "t.c"
    src.write_text(textwrap.dedent("""
        #include <stdint.h>
        extern "C" int target_alpha(int x) { return x + 1; }
        extern "C" int target_beta(int x) { return target_alpha(x) * 2; }
        extern "C" long process_request(int fd, uint64_t req_id, const char* path,
                                        double w) {
            return (long)fd + (long)req_id + (long)w + (path ? path[0] : 0);
        }
        int main(void) { return target_beta(20) + (int)process_request(1, 2, "x", 3.0); }
    """))
    out = d / "t.bin"
    subprocess.run(["g++", "-g", "-O0", "-o", str(out), str(src)], check=True,
                   capture_output=True)
    return str(out)


class TestElfReader:
    def test_symbols_of_compiled_binary(self, small_binary):
        rd = ElfReader(small_binary)
        names = {s.name for s in rd.symbols()}
        assert {"target_alpha", "target_beta", "main"} <= names
        a = rd.symbol("target_alpha")
        assert a.is_func and a.size > 0

    def test_symbolize_addr_inside_function(self, small_binary):
        rd = ElfReader(small_binary)
        b = rd.symbol("target_beta")
        assert rd.symbolize(b.addr) == "target_beta"
        assert rd.symbolize(b.addr + b.size - 1) == "target_beta"

    def test_libc_dynsym(self):
        ns = NativeSymbolizer()
        libc = next((p for _, _, _, p in ns.maps if "/libc.so" in p or "/libc-" in p), None)
        assert libc, "no libc mapping found"
        rd = ElfReader(libc)
        assert rd.has_symbol("malloc")
        assert not rd.has_symbol("definitely_not_a_symbol_xyz")

    def test_not_an_elf(self, tmp_path):
        p = tmp_path / "x.txt"
        p.write_text("hello")
        with pytest.raises(ValueError):
            ElfReader(str(p))

    def test_same_symbols_as_the_reference(self, small_binary):
        for path in (small_binary, sys.executable):
            got, want = ElfReader(path), RefElfReader(path)
            assert [(s.name, s.addr, s.size, s.stype) for s in got.symbols()] == [
                (s.name, s.addr, s.size, s.stype) for s in want.symbols()]
            assert got.min_load_vaddr() == want.min_load_vaddr()


class TestNativeSymbolizer:
    def test_live_libc_address(self):
        lc = ctypes.CDLL("libc.so.6")
        addr = ctypes.cast(lc.printf, ctypes.c_void_p).value
        got = NativeSymbolizer().symbolize(addr)
        assert "printf" in got and "libc" in got

    def test_unknown_address_hex(self):
        assert NativeSymbolizer().symbolize(0x10) == hex(0x10)

    def test_python_binary_frame(self):
        """A native frame of the interpreter (its own binary, or the
        libpython it links) symbolizes through ElfReader."""
        addr = ctypes.cast(ctypes.pythonapi.Py_GetVersion, ctypes.c_void_p).value
        got = NativeSymbolizer().symbolize(addr)
        assert got.startswith("Py_GetVersion (") and "python" in got

    def test_profiler_native_sample(self):
        lc = ctypes.CDLL("libc.so.6")
        a1 = ctypes.cast(lc.printf, ctypes.c_void_p).value
        a2 = ctypes.cast(lc.malloc, ctypes.c_void_p).value
        conn = PerfProfilerConnector(push_period_s=0.0)
        conn.add_native_sample([a1, a2], count=3)  # leaf-first: printf, its caller malloc
        rows = conn.transfer_data()["stack_traces.beta"]
        assert rows["count"] == [3]
        folded = rows["stack_trace"][0]
        assert "malloc" in folded and "printf" in folded
        assert folded.index("malloc") < folded.index("printf")  # root first


class TestDwarfReader:
    def test_function_args_names_sizes_locations(self, small_binary):
        r = DwarfReader(small_binary)
        assert "process_request" in r.function_names()
        args = r.function_args("process_request")
        assert [a.name for a in args] == ["fd", "req_id", "path", "w"]
        assert [a.byte_size for a in args] == [4, 8, 8, 8]
        for a in args:  # -O0: every parameter is frame-base relative
            assert a.location is not None and a.location.startswith("fbreg-")
        assert args[0].type_name == "int" and args[2].type_name.endswith("*")

    def test_unknown_function_raises(self, small_binary):
        with pytest.raises(KeyError):
            DwarfReader(small_binary).function_args("nope")

    def test_multi_cu_dwarf5_str_offsets(self, tmp_path):
        a, b = tmp_path / "a.c", tmp_path / "b.c"
        a.write_text('extern "C" int alpha_fn(int first_arg) { return first_arg; }\n')
        b.write_text('extern "C" int beta_fn(long second_arg) { return (int)second_arg; }\n'
                     'extern "C" int alpha_fn(int);\n'
                     "int main(void) { return alpha_fn(beta_fn(1)); }\n")
        out = tmp_path / "multi"
        subprocess.run(["g++", "-g", "-O0", "-o", str(out), str(a), str(b)], check=True,
                       capture_output=True)
        r = DwarfReader(str(out))
        assert {"alpha_fn", "beta_fn"} <= set(r.function_names())
        assert [x.name for x in r.function_args("alpha_fn")] == ["first_arg"]
        assert [x.name for x in r.function_args("beta_fn")] == ["second_arg"]

    def test_no_debug_info_raises(self, small_binary, tmp_path):
        stripped = tmp_path / "stripped"
        subprocess.run(["g++", "-O0", "-o", str(stripped),
                        str(pathlib.Path(small_binary).parent / "t.c")],
                       check=True, capture_output=True)
        with pytest.raises(ValueError, match="debug_info"):
            DwarfReader(str(stripped))

    def test_same_functions_as_the_reference(self, small_binary):
        got, want = DwarfReader(small_binary), RefDwarfReader(small_binary)
        assert sorted(got.function_names()) == sorted(want.function_names())
        for fn in ("process_request", "target_beta"):
            assert [(a.name, a.byte_size, a.location, a.type_name)
                    for a in got.function_args(fn)] == [
                (a.name, a.byte_size, a.location, a.type_name)
                for a in want.function_args(fn)]


# ------------------------------------------------ tests/test_perf_profiler.py's cases
def busy_marker_function(stop):
    x = 0
    while not stop.is_set():
        x = (x + 1) % 1000003
    return x


def test_fold_stack_shape():
    s = fold_stack(sys._getframe())
    assert "test_torch_obj_tools.test_fold_stack_shape" in s
    assert ";" in s or s.count(".") >= 1  # root-first chain


def test_profiler_samples_busy_thread_and_feeds_table():
    stop = threading.Event()
    worker = threading.Thread(target=busy_marker_function, args=(stop,), name="busy-marker")
    worker.start()
    collector = Collector()
    prof = PerfProfilerConnector(hz=200.0, push_period_s=0.5)
    collector.register(prof)
    try:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and prof.samples_taken < 50:
            time.sleep(0.05)
        assert prof.samples_taken >= 50
        collector.transfer_once()
    finally:
        stop.set()
        worker.join(timeout=10)
        collector.stop()
    assert not worker.is_alive()
    t = collector.store.table("stack_traces.beta")
    assert t.stats()["rows_written"] > 0
    q = compile_pxl(
        "import px\n"
        "df = px.DataFrame(table='stack_traces.beta')\n"
        "df = df.groupby('stack_trace').agg(cnt=('count', px.sum))\n"
        "px.display(df, 'flame')\n",
        collector.store.schemas(),
    )
    df = execute_plan(q.plan, collector.store, device="cpu")["flame"].to_pandas()
    marked = df[df.stack_trace.str.contains("busy_marker_function")]
    assert not marked.empty
    # an absolute bound, not a share: other daemon threads get sampled too
    assert marked["cnt"].sum() >= 20


def test_profiler_upid_is_the_scanners():
    """The profiler stamps the /proc-derived UPID, so ctx['pod'] joins its
    rows to the process the scanner binds."""
    import os

    from pixie_tpu_torch.metadata.proc_scanner import ProcScanner

    conn = PerfProfilerConnector(asid=2)
    assert conn._upid == ProcScanner(asid=2).upid_of(os.getpid())
