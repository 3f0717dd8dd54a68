"""The port stands alone: it imports neither JAX nor pixie_tpu, its entry
points refuse to run on the CPU unless asked to, and a missing CUDA compiler
is a clear error, never a silent fallback."""
import ast
import os
import pathlib
import subprocess
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "pixie_tpu_torch"


def _is_banned(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "pixie_tpu")


def test_importing_every_module_pulls_in_no_jax():
    code = (
        "import importlib, pkgutil, sys, pixie_tpu_torch\n"
        "for m in pkgutil.walk_packages(pixie_tpu_torch.__path__, 'pixie_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pixie_tpu'))\n"
        "print(len([m for m in sys.modules if m.startswith('pixie_tpu_torch')]))\n"
        "sys.exit('imported: ' + ', '.join(bad) if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_no_jax_or_reference_import(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert not any(_is_banned(n) for n in names), (path, node.lineno, names)


def test_execute_plan_without_device_refuses_the_cpu():
    import torch

    from pixie_tpu_torch.engine import execute_plan
    from pixie_tpu_torch.plan import Plan
    from pixie_tpu_torch.status import Unavailable
    from pixie_tpu_torch.table import TableStore

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(Unavailable, match="CUDA"):
        execute_plan(Plan(), TableStore())


def test_local_cluster_without_device_refuses_the_cpu():
    import torch

    from pixie_tpu_torch.parallel import LocalCluster
    from pixie_tpu_torch.status import Unavailable
    from pixie_tpu_torch.table import TableStore

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(Unavailable, match="CUDA"):
        LocalCluster({"pem0": TableStore()})


def test_missing_nvcc_is_a_build_error(tmp_path):
    code = (
        "from pixie_tpu_torch.ops import _build\n"
        "try:\n"
        "    _build.build_all()\n"
        "except _build.KernelUnavailable as e:\n"
        "    print('KernelUnavailable:', e)\n"
    )
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               CUDA_PATH=str(tmp_path))
    if (pathlib.Path("/usr/local/cuda") / "bin" / "nvcc").exists():
        pytest.skip("a CUDA toolkit is installed at its default prefix")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert "KernelUnavailable: nvcc not found" in out.stdout


@pytest.mark.parametrize("mod", ["pixie_tpu_torch.ops.chain", "pixie_tpu_torch.engine.stream",
                                 "pixie_tpu_torch.parallel.streaming",
                                 "pixie_tpu_torch.table.delta"])
def test_streaming_and_chain_modules_import_alone(mod):
    """Each module of the streaming slice, imported on its own, pulls in no
    JAX and nothing of the reference."""
    code = (
        f"import importlib, sys\nimportlib.import_module({mod!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pixie_tpu'))\n"
        "sys.exit('imported: ' + ', '.join(bad) if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_stream_pxl_without_device_refuses_the_cpu():
    import torch

    from pixie_tpu_torch.engine.stream import stream_pxl
    from pixie_tpu_torch.status import Unavailable
    from pixie_tpu_torch.table import TableStore
    from pixie_tpu_torch.types import DataType as DT, Relation

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    ts = TableStore()
    ts.create("t", Relation.of(("time_", DT.TIME64NS), ("x", DT.INT64)))
    with pytest.raises(Unavailable, match="CUDA"):
        stream_pxl("df = px.DataFrame(table='t').stream()\npx.display(df, 'o')\n", ts)


@pytest.mark.parametrize("mod", ["pixie_tpu_torch.plan.fusion", "pixie_tpu_torch.metrics",
                                 "pixie_tpu_torch.serving", "pixie_tpu_torch.serving.batching",
                                 "pixie_tpu_torch.ops.gang"])
def test_batching_and_gang_modules_import_alone(mod):
    """Each module of the batching slice, imported on its own, pulls in no
    JAX and nothing of the reference."""
    code = (
        f"import importlib, sys\nimportlib.import_module({mod!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pixie_tpu'))\n"
        "sys.exit('imported: ' + ', '.join(bad) if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_gang_cuda_tensor_never_reaches_the_plain_version_on_the_cpu():
    """A CUDA device never runs the plain gang: without a card the launch
    raises instead of carrying on on the CPU."""
    import torch

    from pixie_tpu_torch.ops import chain as c1
    from pixie_tpu_torch.ops import gang as g1

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the launch is valid here")
    prog, _bnd = c1.op_program("add", [c1.I64, c1.I64])
    state = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(Exception):
        g1.run([g1.Member(prog, [], [], [], 1, [g1.Leaf("count", state)])], 4,
               torch.device("cuda"))
    assert int(state[0]) == 0


@pytest.mark.parametrize("mod", ["pixie_tpu_torch.parallel.spmd",
                                 "pixie_tpu_torch.parallel.repartition",
                                 "pixie_tpu_torch.ops.repartition"])
def test_mesh_modules_import_alone(mod):
    """Each module of the mesh slice, imported on its own, pulls in no JAX
    and nothing of the reference."""
    code = (
        f"import importlib, sys\nimportlib.import_module({mod!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pixie_tpu'))\n"
        "sys.exit('imported: ' + ', '.join(bad) if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_make_mesh_without_device_refuses_the_cpu():
    """A mesh's shards sit on the card unless the caller asks for the CPU."""
    import torch

    from pixie_tpu_torch.parallel.spmd import make_mesh
    from pixie_tpu_torch.status import Unavailable

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(Unavailable, match="CUDA"):
        make_mesh(1)
    assert make_mesh(1, device="cpu").device.type == "cpu"


def test_repartition_cuda_tensor_never_reaches_the_plain_version_on_the_cpu():
    """X1 and X2 on a CUDA device never run their plain versions: without a
    card the launch raises instead of carrying on on the CPU."""
    import torch

    from pixie_tpu_torch.ops import repartition as rk

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the launch is valid here")
    with pytest.raises(Exception):
        rk.partition_count([(torch.zeros(8, dtype=torch.int64, device="cuda"), None)],
                           [4, 4], 2)
    with pytest.raises(Exception):
        part = torch.zeros(8, dtype=torch.int32, device="cuda")
        rk.partition_scatter(part, torch.zeros((2, 1, 2), dtype=torch.int64, device="cuda"),
                             torch.zeros((2, 2), dtype=torch.int64, device="cuda"),
                             [part], 2, 4)


@pytest.mark.parametrize("mod", ["pixie_tpu_torch.ops.pack", "pixie_tpu_torch.ops.finalize"])
def test_finalize_modules_import_alone(mod):
    """Each module of the device-finalize slice, imported on its own, pulls in
    no JAX and nothing of the reference."""
    code = (
        f"import importlib, sys\nimportlib.import_module({mod!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pixie_tpu'))\n"
        "sys.exit('imported: ' + ', '.join(bad) if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_fused_finalize_on_a_cuda_device_never_reaches_the_plain_version(monkeypatch):
    """F1 asked for a CUDA device takes the kernel's route: without a card it
    raises instead of carrying on with its plain version on the CPU."""
    import torch

    from pixie_tpu_torch.ops import finalize as fin
    from pixie_tpu_torch.ops import gang as g1
    from pixie_tpu_torch.udf.udf import CountUDA

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the launch is valid here")

    def boom(*a, **k):
        raise AssertionError("plain version reached for a CUDA device")

    monkeypatch.setattr(fin, "merge_finalize_plain", boom)
    monkeypatch.setattr(g1, "run_plain", boom)
    uda = CountUDA()
    with pytest.raises(Exception) as e:
        fin.fused_partial_finalize(lambda st: None, lambda d: {"n": uda.init(4, None, d)},
                                   {"n": "add"}, {}, 16, torch.device("cuda"))
    assert "plain version reached" not in str(e.value)


@pytest.mark.parametrize("mod", ["pixie_tpu_torch.native.build", "pixie_tpu_torch.native.codegen",
                                 "pixie_tpu_torch.engine.np_partial",
                                 "pixie_tpu_torch.engine.autotune",
                                 "pixie_tpu_torch.engine.autotune_bench"])
def test_cpu_route_modules_import_alone(mod):
    """Each module of the CPU route, imported on its own, pulls in no JAX and
    nothing of the reference."""
    code = (
        f"import importlib, sys\nimportlib.import_module({mod!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pixie_tpu'))\n"
        "sys.exit('imported: ' + ', '.join(bad) if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _code_strings(tree):
    """String constants of a module that are not docstrings."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_no_module_reads_the_reference_native_directory(path):
    """No code string names the repo-root native/ directory or
    pixie_tpu/native: the port builds from its own copies
    (pixie_tpu_torch/native/*.cc)."""
    for s in _code_strings(ast.parse((ROOT / path).read_text())):
        assert s != "native" and not s.startswith("native/"), (path, s)
        assert "pixie_tpu/native" not in s and "libpixie_native.so" not in s, (path, s)


def test_native_build_reads_only_the_port_sources():
    from pixie_tpu_torch.native import build

    assert build.SRC_DIR == PKG / "native"
    assert build.BUILD_DIR == PKG / "_build"
    assert all((build.SRC_DIR / s).is_file() for s in build.SOURCES)


@pytest.mark.parametrize("mod", ["pixie_tpu_torch.engine.semantics", "pixie_tpu_torch.check",
                                 "pixie_tpu_torch.check.planverify", "pixie_tpu_torch.serving.slo",
                                 "pixie_tpu_torch.observe", "pixie_tpu_torch.table.heat",
                                 "pixie_tpu_torch.table.journal",
                                 "pixie_tpu_torch.table.lifecycle",
                                 "pixie_tpu_torch.table.tablets",
                                 "pixie_tpu_torch.services.wire"])
def test_host_layer_modules_import_alone(mod):
    """Each module of the host-layer slice, imported on its own, pulls in no
    JAX and nothing of the reference."""
    code = (
        f"import importlib, sys\nimportlib.import_module({mod!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pixie_tpu'))\n"
        "sys.exit('imported: ' + ', '.join(bad) if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("mod", ["pixie_tpu_torch.metadata", "pixie_tpu_torch.metadata.state",
                                 "pixie_tpu_torch.metadata.funcs",
                                 "pixie_tpu_torch.metadata.proc_scanner",
                                 "pixie_tpu_torch.metadata.watch", "pixie_tpu_torch.udf.udtf",
                                 "pixie_tpu_torch.collect", "pixie_tpu_torch.collect.core",
                                 "pixie_tpu_torch.collect.schemas",
                                 "pixie_tpu_torch.collect.seq_gen",
                                 "pixie_tpu_torch.collect.replay",
                                 "pixie_tpu_torch.collect.proc_stats",
                                 "pixie_tpu_torch.collect.access_log",
                                 "pixie_tpu_torch.collect.perf_profiler",
                                 "pixie_tpu_torch.obj_tools",
                                 "pixie_tpu_torch.obj_tools.elf_reader",
                                 "pixie_tpu_torch.obj_tools.dwarf_reader"])
def test_metadata_and_collect_modules_import_alone(mod):
    """Each module of the metadata / UDTF / collector slice, imported on its
    own, pulls in no JAX and nothing of the reference, and leaves the
    registry whole (135 scalar names, 8 UDTFs)."""
    code = (
        f"import importlib, sys\nimportlib.import_module({mod!r})\n"
        "from pixie_tpu_torch.udf import registry\n"
        "n = registry.names()\n"
        "assert (len(n['scalar']), len(n['udtf'])) == (135, 8), n\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pixie_tpu'))\n"
        "sys.exit('imported: ' + ', '.join(bad) if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_journal_and_cold_tier_write_only_under_the_data_dir(tmp_path, monkeypatch):
    """With PL_DATA_DIR set, a journaled table with the cold tier on writes
    its segments, schema and cold files under PL_DATA_DIR/<node> and
    nowhere else: not in the working directory, not beside the package."""
    import numpy as np

    from pixie_tpu_torch import flags
    from pixie_tpu_torch.table import journal, lifecycle
    from pixie_tpu_torch.table import TableStore
    from pixie_tpu_torch.types import DataType as DT, Relation

    data_dir, cwd = tmp_path / "data", tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    def package_files():
        return {p for p in PKG.rglob("*")
                if "_build" not in p.parts and "__pycache__" not in p.parts}

    before = package_files()
    saved = {k: flags.get(k) for k in ("PL_DATA_DIR", "PL_COLD_TIER", "PL_COLD_MAX_HOT_MB")}
    flags.set_for_testing("PL_DATA_DIR", str(data_dir))
    flags.set_for_testing("PL_COLD_TIER", 1)
    flags.set_for_testing("PL_COLD_MAX_HOT_MB", 1)
    try:
        store = TableStore()
        t = store.create("t", Relation.of(("time_", DT.TIME64NS), ("s", DT.STRING),
                                          ("x", DT.INT64)), batch_rows=4096)
        journal.attach_store(store, journal.node_dir("pem0"))
        n = 200_000
        t.write({"time_": np.arange(n, dtype=np.int64), "s": ["a", "b"] * (n // 2),
                 "x": np.arange(n, dtype=np.int64)})
        assert t.cold is not None and t.cold.stats()["demotions"] > 0
        journal.detach_store(store)
    finally:
        for k, v in saved.items():
            flags.set_for_testing(k, v)
    written = [p for p in data_dir.rglob("*") if p.is_file()]
    assert any(p.suffix == ".jrn" for p in written)
    assert any(p.suffix == ".pxc" for p in written)
    assert all(p.relative_to(data_dir).parts[0] == "pem0" for p in written)
    assert list(cwd.iterdir()) == []
    assert package_files() == before
    assert lifecycle.cold_dir(str(data_dir / "pem0"), "t").startswith(str(data_dir))


@pytest.mark.parametrize("mod", ["pixie_tpu_torch.collect.protocols",
                                 *(f"pixie_tpu_torch.collect.protocols.{m}" for m in (
                                     "base", "http", "mysql", "pgsql", "dns", "redis", "cql",
                                     "kafka", "nats", "mux", "http2")),
                                 "pixie_tpu_torch.collect.tracer", "pixie_tpu_torch.collect.tap",
                                 "pixie_tpu_torch.testing.socket_traffic"])
def test_socket_tracer_modules_import_alone(mod):
    """Each module of the socket-tracer slice (and its seeded traffic),
    imported on its own, pulls in no JAX and nothing of the reference, and
    the parser registry holds the ten protocols."""
    code = (
        f"import importlib, sys\nimportlib.import_module({mod!r})\n"
        "from pixie_tpu_torch.collect.protocols import parser_registry\n"
        "assert sorted(parser_registry()) == ['cql', 'dns', 'http', 'http2', 'kafka', "
        "'mux', 'mysql', 'nats', 'pgsql', 'redis'], sorted(parser_registry())\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pixie_tpu'))\n"
        "sys.exit('imported: ' + ', '.join(bad) if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


SERVICE_MODULES = [
    "pixie_tpu_torch.services", "pixie_tpu_torch.services.faultinject",
    "pixie_tpu_torch.services.transport", "pixie_tpu_torch.services.kvstore",
    "pixie_tpu_torch.services.registry", "pixie_tpu_torch.services.health",
    "pixie_tpu_torch.services.election", "pixie_tpu_torch.services.cron",
    "pixie_tpu_torch.serving.admission", "pixie_tpu_torch.serving.ratemodel",
    "pixie_tpu_torch.serving.scheduler", "pixie_tpu_torch.services.client",
    "pixie_tpu_torch.services.agent", "pixie_tpu_torch.services.broker",
]


def test_service_modules_pull_in_no_jax():
    """The networked deployment's modules, imported in turn in a fresh
    interpreter (the lightest first): after each, no JAX and nothing of the
    reference is in sys.modules."""
    code = (
        "import importlib, sys\n"
        f"for mod in {SERVICE_MODULES!r}:\n"
        "    importlib.import_module(mod)\n"
        "    bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pixie_tpu'))\n"
        "    if bad:\n"
        "        sys.exit(mod + ' imported: ' + ', '.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


_AGENT_PROCESS = """
import os, sys, threading, time
sys.argv = ["agent", "--name", "iso", "--broker", sys.argv[1], "--connector", "seq_gen",
            "--heartbeat-s", "0.5", "--device", "cpu"]
from pixie_tpu_torch.services import agent
threading.Thread(target=agent.main, daemon=True).start()
flag = os.environ["ISO_FLAG"]
end = time.monotonic() + 60
while not os.path.exists(flag) and time.monotonic() < end:
    time.sleep(0.1)
bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pixie_tpu'))
print('answered' if os.path.exists(flag) else 'no query', ','.join(bad) or 'clean')
sys.stdout.flush()
os._exit(0)
"""


def test_agent_process_serves_a_query_without_jax(tmp_path):
    """`python -m pixie_tpu_torch.services.agent --device cpu`'s main, in its
    own process, registers, answers a query, and holds no JAX and nothing
    of the reference afterwards."""
    from pixie_tpu_torch.services.broker import Broker
    from pixie_tpu_torch.services.client import Client

    broker = Broker(hb_expiry_s=5.0, query_timeout_s=60.0, device="cpu").start()
    flag = tmp_path / "answered"
    proc = subprocess.Popen([sys.executable, "-c", _AGENT_PROCESS, f"127.0.0.1:{broker.port}"],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "ISO_FLAG": str(flag)})
    try:
        end = time.monotonic() + 60
        while not any(a.name == "iso" for a in broker.registry.live_agents()):
            assert proc.poll() is None, proc.stderr.read()[-2000:]
            assert time.monotonic() < end
            time.sleep(0.1)
        time.sleep(1.0)  # seq_gen's first batches
        client = Client("127.0.0.1", broker.port, timeout_s=60.0)
        res = client.execute_script(
            "df = px.DataFrame(table='seq0')\n"
            "df = df.agg(cnt=('x', px.count))\npx.display(df, 'out')\n")["out"]
        client.close()
        assert int(res.to_pandas()["cnt"][0]) > 0
        assert res.exec_stats["agents"]["iso"]["torch_device"] == "cpu"
        flag.write_text("1")
        out, err = proc.communicate(timeout=60)
        assert out.split() == ["answered", "clean"], err[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        broker.stop()
