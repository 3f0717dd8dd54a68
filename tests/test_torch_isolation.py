"""The port stands alone: it imports neither JAX nor pixie_tpu, its entry
points refuse to run on the CPU unless asked to, and a missing CUDA compiler
is a clear error, never a silent fallback."""
import ast
import os
import pathlib
import subprocess
import sys

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
