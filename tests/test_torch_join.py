"""Equijoins: plans with a JoinOp run through pixie_tpu.engine and through
pixie_tpu_torch.engine (device="cpu") over the same rows, the join's match
phase (the plain versions of J1-J3, ops/join_device.py) against the
reference's `_match_pairs`, and the device-join gate.

Plans are built (or compiled) by the reference and carried across with
Plan.to_dict / plan_from_dict; the tables are written from the same numpy
columns into both packages' stores, so dictionary codes agree.  A join only
moves rows, and its pair order is unspecified, so results are compared as
frames sorted on every column, exactly (float payloads only move).
"""
import numpy as np
import pandas as pd
import pytest

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
from pixie_tpu import flags as ref_flags
from pixie_tpu.compiler import compile_fn
from pixie_tpu.engine import execute_plan as ref_execute
from pixie_tpu.engine.executor import _match_pairs as ref_match_pairs
from pixie_tpu.plan import (
    AggExpr, AggOp, JoinOp, MemorySinkOp, MemorySourceOp, Plan,
)
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.types import DataType as DT, Relation

import pixie_tpu_torch.interop as interop
from pixie_tpu_torch import flags as port_flags
from pixie_tpu_torch.engine.executor import PlanExecutor
from pixie_tpu_torch.ops import join_device as jd

HOWS = ["inner", "left", "right", "outer"]


def both_stores(tables: dict, batch_rows: int = 1 << 16):
    """name → (Relation, {column: values}) written into a reference and a
    port store."""
    ref = RefStore()
    for name, (rel, cols) in tables.items():
        ref.create(name, rel, batch_rows=batch_rows).write(
            {k: np.asarray(v).copy() for k, v in cols.items()})
    port = interop.store_from_columns(
        {name: (rel.to_dict(), {k: np.asarray(v).copy() for k, v in cols.items()})
         for name, (rel, cols) in tables.items()}, batch_rows=batch_rows)
    return ref, port


def _sorted(res):
    """(raw columns, decoded columns) sorted on every raw column."""
    raw = pd.DataFrame({n: np.asarray(res.columns[n]) for n in res.relation.names()})
    order = raw.sort_values(list(raw.columns), kind="stable").index
    dec = res.to_pandas().loc[order].reset_index(drop=True)
    return raw.loc[order].reset_index(drop=True), dec


def assert_same_join(got, want):
    assert got.relation.names() == want.relation.names()
    assert [c.data_type for c in got.relation] == [c.data_type for c in want.relation]
    assert got.num_rows == want.num_rows
    g_raw, g_dec = _sorted(got)
    w_raw, w_dec = _sorted(want)
    pd.testing.assert_frame_equal(g_raw, w_raw, check_exact=True)
    pd.testing.assert_frame_equal(g_dec, w_dec, check_exact=True)


def run_both(stores, plan, sink="output"):
    ref, port = stores
    want = ref_execute(plan, ref)[sink]
    ex = PlanExecutor(interop.plan_from_dict(plan.to_dict()), port, device="cpu")
    got = ex.run()[sink]
    assert_same_join(got, want)
    return got, want, ex


# ------------------------------------------------ tests/test_join.py mirrored

LR_REL = {
    "lhs": Relation.of(("k", DT.STRING), ("ki", DT.INT64), ("lv", DT.FLOAT64)),
    "rhs": Relation.of(("k", DT.STRING), ("ki", DT.INT64), ("rv", DT.FLOAT64)),
}


def lr_stores(lrows, rrows):
    return both_stores({"lhs": (LR_REL["lhs"], lrows), "rhs": (LR_REL["rhs"], rrows)})


def merge_plan(stores, how, left_on, right_on):
    def build(px):
        l = px.DataFrame(table="lhs")
        r = px.DataFrame(table="rhs")
        return l.merge(r, how=how, left_on=left_on, right_on=right_on)

    return compile_fn(build, stores[0].schemas()).plan


@pytest.mark.parametrize("how", HOWS)
def test_many_to_many_string_key(how):
    st = lr_stores(
        {"k": ["a", "a", "b", "c", "c", "c", "only_l"],
         "ki": [1, 2, 3, 4, 5, 6, 7],
         "lv": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0]},
        {"k": ["a", "b", "b", "c", "only_r"],
         "ki": [10, 30, 31, 40, 99],
         "rv": [0.1, 0.3, 0.31, 0.4, 0.9]},
    )
    got, _, _ = run_both(st, merge_plan(st, how, "k", "k"))
    assert got.num_rows == {"inner": 7, "left": 8, "right": 8, "outer": 9}[how]


@pytest.mark.parametrize("how", HOWS)
def test_int_key_join(how):
    st = lr_stores(
        {"k": ["x"] * 6, "ki": [1, 1, 2, 3, 3, 9], "lv": np.arange(6.0)},
        {"k": ["y"] * 5, "ki": [1, 2, 2, 3, 8], "rv": np.arange(5.0)},
    )
    run_both(st, merge_plan(st, how, "ki", "ki"))


@pytest.mark.parametrize("how", HOWS)
def test_multi_key_join(how):
    rng = np.random.default_rng(5)
    n = 300
    st = lr_stores(
        {"k": rng.choice(["a", "b", "c"], n), "ki": rng.integers(0, 4, n),
         "lv": rng.normal(size=n)},
        {"k": rng.choice(["b", "c", "d"], n), "ki": rng.integers(0, 4, n),
         "rv": rng.normal(size=n)},
    )
    run_both(st, merge_plan(st, how, ["k", "ki"], ["k", "ki"]))


@pytest.mark.parametrize("how", HOWS)
def test_null_keys_never_match_but_survive(how):
    """Null string keys (dict code -1 from an unmatched first left join) do
    not pair with each other; their rows still surface in left/outer."""
    st = both_stores({
        "a": (Relation.of(("k", DT.STRING), ("v", DT.INT64)),
              {"k": ["p", "q", "r"], "v": [1, 2, 3]}),
        "b": (Relation.of(("k", DT.STRING), ("name", DT.STRING)),
              {"k": ["p"], "name": ["P"]}),
        "c": (Relation.of(("name", DT.STRING), ("w", DT.INT64)),
              {"name": ["P", "Z"], "w": [10, 20]}),
    })

    def build(px):
        j = px.DataFrame(table="a").merge(px.DataFrame(table="b"), how="left",
                                          left_on="k", right_on="k")
        return j.merge(px.DataFrame(table="c"), how=how, left_on="name",
                       right_on="name")

    plan = compile_fn(build, st[0].schemas()).plan
    got, _, _ = run_both(st, plan)
    assert got.num_rows == {"inner": 1, "left": 3, "right": 2, "outer": 4}[how]


@pytest.mark.parametrize("how", HOWS)
def test_empty_sides(how):
    st = lr_stores({"k": [], "ki": [], "lv": []},
                   {"k": ["a"], "ki": [1], "rv": [1.0]})
    got, _, _ = run_both(st, merge_plan(st, how, "k", "k"))
    assert got.num_rows == {"inner": 0, "left": 0, "right": 1, "outer": 1}[how]


@pytest.mark.parametrize("how", HOWS)
def test_nan_float_keys_match_like_pandas(how):
    st = both_stores({
        "lhs": (Relation.of(("a", DT.FLOAT64), ("b", DT.INT64), ("lv", DT.INT64)),
                {"a": [np.nan, 1.0, 2.0], "b": [1, 1, 2], "lv": [10, 11, 12]}),
        "rhs": (Relation.of(("a", DT.FLOAT64), ("b", DT.INT64), ("rv", DT.INT64)),
                {"a": [np.nan, 1.0, 3.0], "b": [1, 1, 3], "rv": [20, 21, 23]}),
    })
    got, _, _ = run_both(st, merge_plan(st, how, ["a", "b"], ["a", "b"]))
    df = got.to_pandas()
    assert len(df[(df.lv == 10) & (df.rv == 20)]) == 1  # (NaN, 1) joined (NaN, 1)


def _cross_plan(how):
    p = Plan()
    l = p.add(MemorySourceOp(table="lhs"))
    r = p.add(MemorySourceOp(table="rhs"))
    j = p.add(JoinOp(how=how, left_on=[], right_on=[],
                     output=[("left", "k", "lk"), ("left", "lv", "lv"),
                             ("right", "k", "rk"), ("right", "rv", "rv")]),
              parents=[l, r])
    p.add(MemorySinkOp(name="output"), parents=[j])
    return p


@pytest.mark.parametrize("how", HOWS)
def test_cross_join(how):
    st = lr_stores({"k": ["a", "b", "c"], "ki": [1, 2, 3], "lv": [1.0, 2.0, 3.0]},
                   {"k": ["x", "y"], "ki": [7, 8], "rv": [0.5, 0.25]})
    got, _, _ = run_both(st, _cross_plan(how))
    assert got.num_rows == 6


@pytest.mark.parametrize("how", HOWS)
def test_cross_join_with_an_empty_side(how):
    st = lr_stores({"k": ["a", "b"], "ki": [1, 2], "lv": [1.0, 2.0]},
                   {"k": [], "ki": [], "rv": []})
    got, _, _ = run_both(st, _cross_plan(how))
    assert got.num_rows == (2 if how in ("left", "outer") else 0)


# ------------------------------------- tests/test_join_device.py mirrored


def _kv_plan(how):
    p = Plan()
    l = p.add(MemorySourceOp(table="left"))
    r = p.add(MemorySourceOp(table="right"))
    j = p.add(JoinOp(how=how, left_on=["k"], right_on=["k"],
                     output=[("left", "k", "k"), ("left", "a", "a"), ("right", "b", "b")]),
              parents=[l, r])
    p.add(MemorySinkOp(name="out"), parents=[j])
    return p


def _kv_stores(n, seed, lkeys, rkeys):
    rng = np.random.default_rng(seed)
    return both_stores({
        "left": (Relation.of(("k", DT.INT64), ("a", DT.INT64)),
                 {"k": rng.integers(*lkeys, n), "a": np.arange(n, dtype=np.int64)}),
        "right": (Relation.of(("k", DT.INT64), ("b", DT.INT64)),
                  {"k": rng.integers(*rkeys, n), "b": np.arange(n, dtype=np.int64)}),
    })


@pytest.fixture(scope="module")
def device_join_stores():
    """test_join_device.py's executor-parity tables: 2^17 rows a side, m:n
    duplicates and keys unique to each side."""
    n = 1 << 17
    return _kv_stores(n, 11, (0, n // 8), (n // 16, n // 8 + n // 16))


@pytest.fixture
def gate(request):
    """Force PX_DEVICE_JOIN in both packages for one test."""
    def force(value):
        ref_flags.set_for_testing("PX_DEVICE_JOIN", value)
        port_flags.set_for_testing("PX_DEVICE_JOIN", value)
        jd.reset_gate_for_testing()

    yield force
    force(-1)


@pytest.mark.parametrize("how", HOWS)
def test_device_join_parity_gate_forced_on(device_join_stores, gate, how):
    gate(1)
    got, want, ex = run_both(device_join_stores, _kv_plan(how), sink="out")
    assert ex.stats["device_joins"] == 1
    assert ex.stats["device"]["join_gate"] == {"enabled": True, "reason": "forced_on",
                                               "path": "plain_cpu"}
    assert want.exec_stats.get("device_joins", 0) == 1


def test_device_join_forced_off_matches(device_join_stores, gate):
    gate(0)
    got, _, ex = run_both(device_join_stores, _kv_plan("inner"), sink="out")
    assert ex.stats.get("device_joins", 0) == 0
    assert ex.stats["device"]["join_gate"]["reason"] == "forced_off"


def test_small_joins_stay_on_host(gate):
    gate(1)
    st = _kv_stores(1000, 9, (0, 250), (0, 250))
    _, _, ex = run_both(st, _kv_plan("inner"), sink="out")
    assert ex.stats.get("device_joins", 0) == 0
    assert "device" not in ex.stats


def test_gate_forced_off_and_on():
    for flag, enabled, reason in ((0, False, "forced_off"), (1, True, "forced_on")):
        port_flags.set_for_testing("PX_DEVICE_JOIN", flag)
        jd.reset_gate_for_testing()
        try:
            g = jd.device_join_gate("cpu")
            assert g["enabled"] is enabled and g["reason"] == reason
        finally:
            port_flags.set_for_testing("PX_DEVICE_JOIN", -1)
            jd.reset_gate_for_testing()


def test_auto_gate_on_the_cpu_keeps_the_host_match(device_join_stores):
    jd.reset_gate_for_testing()
    g = jd.device_join_gate("cpu")
    assert g == {"flag": -1, "path": "plain_cpu", "enabled": False,
                 "reason": "no_native_kernel"}
    _, _, ex = run_both(device_join_stores, _kv_plan("left"), sink="out")
    assert ex.stats.get("device_joins", 0) == 0
    assert ex.stats["device"]["join_gate"]["reason"] == "no_native_kernel"


def test_analyze_records_the_join_split(device_join_stores, gate):
    gate(1)
    ex = PlanExecutor(interop.plan_from_dict(_kv_plan("inner").to_dict()),
                      device_join_stores[1], device="cpu", analyze=True)
    ex.run()
    (split,) = ex.stats["join_split_s"]
    assert set(split) == {"composite_codes", "h2d", "densify", "j1_build", "j2_probe",
                          "j3_expand", "d2h", "match", "output"}


# ------------------------------------------------------------- config #3


def test_config3_whole_matches_reference():
    """bench_config3 (net_flow_graph shape) at 2^16 rows: per-pod int64 sums,
    a join with the 256-row pods table, per-service sums; exact."""
    rows, n_pods = 1 << 16, 256
    rng = np.random.default_rng(5)
    pods = np.array([f"pod-{i}" for i in range(n_pods)])
    st = both_stores({
        "network_stats": (
            Relation.of(("time_", DT.TIME64NS), ("pod_id", DT.STRING),
                        ("rx_bytes", DT.INT64), ("tx_bytes", DT.INT64)),
            {"time_": np.arange(rows, dtype=np.int64),
             "pod_id": pods[rng.integers(0, n_pods, rows)],
             "rx_bytes": rng.integers(0, 1 << 20, rows),
             "tx_bytes": rng.integers(0, 1 << 20, rows)}),
        "pods": (Relation.of(("pod_id", DT.STRING), ("service", DT.STRING)),
                 {"pod_id": pods,
                  "service": np.array([f"svc-{i % 24}" for i in range(n_pods)])}),
    })
    p = Plan()
    agg = p.add(AggOp(groups=["pod_id"], values=[
        AggExpr("rx", "sum", "rx_bytes"), AggExpr("tx", "sum", "tx_bytes")]),
        parents=[p.add(MemorySourceOp(table="network_stats"))])
    join = p.add(JoinOp(how="inner", left_on=["pod_id"], right_on=["pod_id"],
                        output=[("left", "pod_id", "pod_id"), ("left", "rx", "rx"),
                                ("left", "tx", "tx"), ("right", "service", "service")]),
                 parents=[agg, p.add(MemorySourceOp(table="pods"))])
    agg2 = p.add(AggOp(groups=["service"], values=[
        AggExpr("rx", "sum", "rx"), AggExpr("tx", "sum", "tx")]), parents=[join])
    p.add(MemorySinkOp(name="output"), parents=[agg2])
    got, want, ex = run_both(st, p)
    assert got.num_rows == 24
    assert ex.stats.get("device_joins", 0) == 0  # 256 rows: below the gate


# ------------------------------------------------ the match phase's kernels


def _pairs(b, p):
    a = np.stack([np.asarray(b), np.asarray(p)])
    return a[:, np.lexsort(a)]


def _check_codes(lc, rc, lnull=None, rnull=None):
    nl, nr = len(lc), len(rc)
    lnull = np.zeros(nl, bool) if lnull is None else lnull
    rnull = np.zeros(nr, bool) if rnull is None else rnull
    want = ref_match_pairs(lc, rc, lnull, rnull)
    got = jd.device_join_codes(np.where(lnull, np.int64(-1), lc),
                               np.where(rnull, np.int64(-2), rc), device="cpu")
    np.testing.assert_array_equal(_pairs(got[0], got[1]), _pairs(want[0], want[1]))
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    return got


CODE_CASES = {
    "many_to_many_with_nulls": lambda rng: (
        rng.integers(0, 800, 5000), rng.integers(0, 800, 7000),
        rng.random(5000) < 0.05, rng.random(7000) < 0.05),
    "heavy_duplicates": lambda rng: (
        rng.integers(0, 50, 4000), rng.integers(0, 50, 3000), None, None),
    "one_code": lambda rng: (np.full(1500, 42), np.full(900, 42), None, None),
    "no_matches": lambda rng: (np.arange(0, 1000), np.arange(1000, 1500), None, None),
    "all_null_probe": lambda rng: (
        rng.integers(0, 100, 1000), rng.integers(0, 100, 500), None,
        np.ones(500, bool)),
    "wide_sparse": lambda rng: (
        rng.integers(0, 1000, 3000) * (1 << 40), rng.integers(0, 1000, 2000) * (1 << 40),
        None, None),
    "wide_random": lambda rng: (
        rng.integers(0, 1 << 60, 3000), rng.integers(0, 1 << 60, 1000), None, None),
}


@pytest.mark.parametrize("case", sorted(CODE_CASES))
def test_join_kernels_match_reference_pairs(case):
    lc, rc, lnull, rnull = CODE_CASES[case](np.random.default_rng(3))
    got = _check_codes(np.asarray(lc, np.int64), np.asarray(rc, np.int64), lnull, rnull)
    if case in ("no_matches", "all_null_probe"):
        assert len(got[0]) == 0


def test_negative_codes_on_both_sides_are_densified_and_match():
    """Public raw codes: -5 on both sides must pair, as in the reference."""
    b = np.array([-5, 3, -5, 7], np.int64)
    p = np.array([-5, 7, 9], np.int64)
    bidx, pidx, bm, pm = jd.device_join_codes(b, p, device="cpu")
    assert sorted(zip(bidx.tolist(), pidx.tolist())) == [(0, 0), (2, 0), (3, 1)]
    assert bm.tolist() == [True, False, True, True] and pm.tolist() == [True, True, False]


def test_empty_side_gives_no_pairs():
    bidx, pidx, bm, pm = jd.device_join_codes(np.zeros(0, np.int64),
                                              np.arange(4, dtype=np.int64), device="cpu")
    assert len(bidx) == len(pidx) == 0 and len(bm) == 0 and not pm.any()


def test_join_stages_plain():
    """J1-J3's plain versions stage by stage on a small example."""
    import torch

    b = torch.tensor([2, 0, 2, -1, 5, 2])
    cnt, first, rows = jd.join_build(b, 6)
    assert cnt.tolist() == [1, 0, 3, 0, 0, 1]
    assert first.tolist() == [0, 1, 1, 4, 4, 4]
    assert rows.tolist() == [1, 0, 2, 5, 4]
    p = torch.tensor([2, -2, 5, 7, 0])
    cnt_p, lo_p, total = jd.join_probe(p, cnt, first)
    assert cnt_p.tolist() == [3, 0, 1, 0, 1] and int(total) == 5
    assert lo_p.tolist() == [1, 0, 4, 0, 0]
    bidx, pidx, bm, pm = jd.join_expand(cnt_p, lo_p, rows, 6, 5)
    assert list(zip(bidx.tolist(), pidx.tolist())) == [(0, 0), (2, 0), (5, 0), (4, 2),
                                                       (1, 4)]
    assert bm.tolist() == [True, True, True, False, True, True]
    assert pm.tolist() == [True, False, True, False, True]


@pytest.mark.parametrize("npr", [0, 1, 3, 4095, 4096, 4097, 3 * 4096 + 77])
def test_probe_tiles_are_the_cumsum_of_the_counts(npr):
    """J2's tiles (plain version): each 4,096-row tile's offset is the
    cumsum of the counts before it and probe_matched is count > 0; J3 given
    them gives what J3 counting its own tiles gives, in order."""
    import torch

    rng = np.random.default_rng(npr)
    b = torch.from_numpy(rng.integers(-1, 300, 5000))
    p = torch.from_numpy(rng.integers(-2, 400, npr))
    cnt, first, rows = jd.join_build(b, 300)
    cnt_p, lo_p, total, tiles = jd.join_probe(p, cnt, first, tiles=True)
    for x, y in zip((cnt_p, lo_p, total), jd.join_probe(p, cnt, first)):
        assert torch.equal(x, y)
    counts = cnt_p.numpy().astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(counts)])
    np.testing.assert_array_equal(tiles[0].numpy(), cum[np.arange(0, npr, 4096)])
    np.testing.assert_array_equal(tiles[1].numpy(), counts > 0)
    assert int(total) == cum[-1]
    fused = jd.join_expand(cnt_p, lo_p, rows, 5000, int(total), tiles)
    alone = jd.join_expand(cnt_p, lo_p, rows, 5000, int(total))
    for x, y in zip(fused, alone):
        assert torch.equal(x, y)


def _plain_route(b, p):
    """J1-J3's plain versions over two sides' codes → their four outputs
    as numpy."""
    import torch

    bd, pd_, K = jd._dense(torch.from_numpy(b), torch.from_numpy(p))
    cnt, first, rows = jd.join_build_plain(bd, K)
    cnt_p, lo_p, total = jd.join_probe_plain(pd_, cnt, first)
    return [x.numpy() for x in jd.join_expand_plain(cnt_p, lo_p, rows, len(b), int(total))]


_EXPAND_CASES = {
    # one key with 1,024 rows a side over 2^16 background rows
    "heavy_key": lambda rng: (
        np.concatenate([np.full(1024, 7), rng.integers(100, 1 << 18, 1 << 16)]),
        np.concatenate([np.full(1024, 7), rng.integers(100, 1 << 18, 1 << 16)])),
    # the device join phase's ratio: codes in a quarter of the rows' range,
    # about 4 pairs a probe row
    "four_pairs_a_row": lambda rng: (rng.integers(0, 1 << 12, 1 << 14),
                                     rng.integers(0, 1 << 12, 1 << 14)),
}


@pytest.mark.parametrize("case", sorted(_EXPAND_CASES))
def test_join_expand_plain_equals_reference_device_join(case):
    """join_expand_plain's pairs and both flags equal the reference's
    device join; its pairs come grouped by probe row in probe-row order,
    and within a probe row in ascending build row (the order J3 keeps)."""
    from pixie_tpu.ops.join_device import device_join_codes as ref_device_join

    b, p = (np.asarray(x, np.int64) for x in _EXPAND_CASES[case](np.random.default_rng(5)))
    bidx, pidx, bm, pm = _plain_route(b, p)
    want = ref_device_join(b, p)
    np.testing.assert_array_equal(_pairs(bidx, pidx), _pairs(want[0], want[1]))
    np.testing.assert_array_equal(bm, want[2])
    np.testing.assert_array_equal(pm, want[3])
    order = np.lexsort((bidx, pidx))
    np.testing.assert_array_equal(order, np.arange(len(bidx)))
    if case == "four_pairs_a_row":
        assert 3.5 < len(bidx) / len(p) < 4.5
    else:
        assert len(bidx) >= 1024 * 1024


_J1_ORDER_CASES = {
    "uniform": lambda rng: rng.integers(0, 300, 5000),
    "one_code_half": lambda rng: np.where(rng.random(5000) < 0.5, 7, rng.integers(0, 300, 5000)),
    "one_code": lambda rng: np.full(4097, 3),
    "sparse": lambda rng: rng.integers(0, 1 << 20, 3001),
    "past_a_tile": lambda rng: rng.integers(0, 40, 4097),
}


@pytest.mark.parametrize("case", sorted(_J1_ORDER_CASES))
def test_join_build_orders_rows_as_the_reference_pack_sort(case):
    """J1's rows_by_code is the reference's packed sort (code << ib | row):
    grouped by code, ascending rows within a code, with the same counts."""
    import torch
    from pixie_tpu.ops.join_device import _pack_sort

    codes = np.asarray(_J1_ORDER_CASES[case](np.random.default_rng(11)), np.int64)
    n, K = codes.shape[0], int(codes.max()) + 1
    ib = max(1, int(n).bit_length())
    s = np.asarray(_pack_sort(codes, ib, 0))
    cnt, first, rows = jd.join_build(torch.from_numpy(codes), K)
    np.testing.assert_array_equal(rows.numpy(), s & ((1 << ib) - 1))
    np.testing.assert_array_equal(cnt.numpy(), np.bincount(s >> ib, minlength=K))
    np.testing.assert_array_equal(first.numpy(), np.cumsum(cnt.numpy()) - cnt.numpy())
