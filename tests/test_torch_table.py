"""Parity: the port's table store against pixie_tpu.table — the same writes
give the same dictionary codes and the same cursor batches."""
import numpy as np
import pytest

import pixie_tpu  # noqa: F401
from pixie_tpu.table import Dictionary as RefDictionary, TableStore as RefStore
from pixie_tpu.types import DataType as DT, Relation, UInt128

from pixie_tpu_torch.status import InvalidArgument, Unimplemented
from pixie_tpu_torch.table import Dictionary, TableStore
from pixie_tpu_torch.types import Relation as PortRelation

REL = Relation.of(("time_", DT.TIME64NS), ("service", DT.STRING),
                  ("latency", DT.FLOAT64), ("status", DT.INT64),
                  ("ok", DT.BOOLEAN), ("upid", DT.UINT128))


def _writes(seed, sizes):
    rng = np.random.default_rng(seed)
    services = np.array([f"svc-{i}" for i in range(40)] + ["", "ünï", "a b"])
    upids = [UInt128.make_upid(1, i, 7) for i in range(5)]
    t = 0
    for n in sizes:
        yield {
            "time_": np.arange(t, t + n, dtype=np.int64) * 1000,
            "service": services[rng.integers(0, len(services), n)],
            "latency": rng.exponential(5.0, n),
            "status": rng.choice([200, 404, 500], n),
            "ok": rng.random(n) < 0.5,
            "upid": [upids[i] for i in rng.integers(0, 5, n)],
        }
        t += n


def _pair(sizes, seed=1, **kw):
    ref, port = RefStore(), TableStore()
    rt = ref.create("t", REL, **kw)
    pt = port.create("t", PortRelation.from_dict(REL.to_dict()), **kw)
    for w in _writes(seed, sizes):
        rt.write({k: (v.copy() if isinstance(v, np.ndarray) else list(v)) for k, v in w.items()})
        pt.write({k: (v.copy() if isinstance(v, np.ndarray) else list(v)) for k, v in w.items()})
    return rt, pt


def _assert_same_cursor(rc, pc):
    ritems, pitems = list(rc), list(pc)
    assert len(ritems) == len(pitems)
    for (rb, rrid, rgen), (pb, prid, pgen) in zip(ritems, pitems):
        assert (rrid, rgen, rb.num_valid) == (prid, pgen, pb.num_valid)
        assert list(rb.columns) == list(pb.columns)
        for k in rb.columns:
            a, b = rb.columns[k], pb.columns[k]
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert rc.time_range() == pc.time_range()


@pytest.mark.parametrize("sizes", [[10], [1000, 3000, 17], [4096, 4096, 5000]])
def test_dictionary_codes_and_cursor_batches(sizes):
    rt, pt = _pair(sizes, batch_rows=1024)
    for col in ("service", "upid"):
        assert rt.dictionaries[col].values() == pt.dictionaries[col].values()
    _assert_same_cursor(rt.cursor(), pt.cursor())
    assert rt.last_row_id() == pt.last_row_id()


@pytest.mark.parametrize("bounds", [(None, 500_000), (1_000_000, None),
                                    (2_000_000, 3_500_000)])
def test_time_bounded_cursor(bounds):
    rt, pt = _pair([4000, 3000], batch_rows=512)
    _assert_same_cursor(rt.cursor(*bounds), pt.cursor(*bounds))


@pytest.mark.parametrize("since,stop", [(0, None), (700, None), (1000, 2500)])
def test_cursor_since(since, stop):
    rt, pt = _pair([4000, 77], batch_rows=512)
    _assert_same_cursor(rt.cursor_since(since, stop), pt.cursor_since(since, stop))


def test_ring_buffer_expiry():
    rt, pt = _pair([3000, 3000, 3000], batch_rows=512, max_bytes=64 * 1024)
    assert rt.first_row_id() == pt.first_row_id() > 0
    _assert_same_cursor(rt.cursor(), pt.cursor())
    assert rt.stats()["expired_batches"] == pt.stats()["expired_batches"]


@pytest.mark.parametrize("values", [
    ["b", "a", "b", "c", "a"],
    np.array(["x", "y", "x", "zz", ""]),
    ["tail\x00", "tail", "tail\x00"],
    [(1, 2), (3, 4), (1, 2)],
])
def test_dictionary_encode(values):
    rd, pd_ = RefDictionary(), Dictionary()
    for batch in (values, list(values)[::-1]):
        np.testing.assert_array_equal(rd.encode(batch), pd_.encode(batch))
    assert rd.values() == pd_.values()
    codes = np.array([0, -1, len(rd) - 1, len(rd) + 3])
    assert rd.decode(codes) == pd_.decode(codes)


def test_rejected_write_leaves_dictionaries_alone():
    _rt, pt = _pair([10])
    before = pt.dictionaries["service"].values()
    with pytest.raises(InvalidArgument):
        pt.write({"service": ["new"]})
    assert pt.dictionaries["service"].values() == before


def test_unported_hooks_raise():
    """Seal replication (`on_seal`, the services slice) is still refused, on
    a write and on a forced seal.  Tablets and the journal are ported
    (tests/test_torch_tablets.py, tests/test_torch_journal.py)."""
    store = TableStore()
    t = store.create("t", PortRelation.from_dict(REL.to_dict()))
    t.on_seal = lambda table, batches: None
    with pytest.raises(Unimplemented, match="replication"):
        t.write(next(_writes(1, [4])))
    with pytest.raises(Unimplemented, match="replication"):
        t.seal_hot()
