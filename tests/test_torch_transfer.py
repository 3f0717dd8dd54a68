"""engine/transfer.py: readback waves and the memoized link probe, on the
CPU (CPU tensors pass through a wave; the H2D probe needs a CUDA device)."""
import numpy as np
import pytest
import torch

from pixie_tpu_torch import flags
from pixie_tpu_torch.engine import transfer
from pixie_tpu_torch.ops import join_device as jd


def test_pull_keeps_the_tree_and_returns_numpy():
    tree = {"a": torch.arange(5), "b": [torch.ones(2, dtype=torch.float64), np.arange(3)],
            "c": (torch.tensor(True),)}
    out = transfer.pull(tree)
    assert set(out) == {"a", "b", "c"}
    np.testing.assert_array_equal(out["a"], np.arange(5))
    assert isinstance(out["b"], list) and isinstance(out["c"], tuple)
    np.testing.assert_array_equal(out["b"][0], np.ones(2))
    np.testing.assert_array_equal(out["b"][1], np.arange(3))
    assert out["c"][0].dtype == np.bool_ and bool(out["c"][0])


def test_async_pull_waits_once():
    h = transfer.pull_async([torch.arange(4)])
    assert h.n_dev == 0  # CPU tensors: nothing to copy
    first = h.wait()
    assert h.wait() is first
    np.testing.assert_array_equal(first[0], np.arange(4))


def test_probe_cache_memoizes_and_expires(monkeypatch):
    transfer.reset_probe_cache_for_testing()
    calls = []

    def measure():
        calls.append(1)
        return {"mbps": 5.0 * len(calls)}

    clock = [100.0]
    monkeypatch.setattr(transfer, "_now", lambda: clock[0])
    epoch = transfer.probe_epoch()
    assert transfer._probe_cached("k", measure, False) == {"mbps": 5.0}
    assert transfer._probe_cached("k", measure, False) == {"mbps": 5.0}
    assert len(calls) == 1
    clock[0] += float(flags.get("PX_PROBE_MAX_AGE_S")) + 1
    assert transfer._probe_cached("k", measure, False) == {"mbps": 10.0}
    assert transfer.probe_epoch() == epoch + 1  # expiry re-opens derived decisions
    assert transfer._probe_cached("k", measure, True) == {"mbps": 15.0}
    transfer.invalidate_probes()
    assert transfer.probe_epoch() == epoch + 2
    transfer.reset_probe_cache_for_testing()


def test_invalidate_probes_reopens_the_join_gate():
    jd.reset_gate_for_testing()
    g = jd.device_join_gate("cpu")
    assert jd.device_join_gate("cpu") is g  # cached
    transfer.invalidate_probes()
    assert jd.device_join_gate("cpu") is not g


def test_h2d_probe_needs_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA"):
        transfer.h2d_bandwidth_probe(device="cpu")


def test_to_device_on_the_cpu_copies_nothing_it_need_not():
    a = np.arange(6, dtype=np.int64)
    t = transfer.to_device(a, torch.device("cpu"))
    assert t.dtype == torch.int64 and t.tolist() == a.tolist()
