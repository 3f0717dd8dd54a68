"""Keyed repartition and repartitioned joins: pixie_tpu_torch against
pixie_tpu.

The cases of tests/test_repartition.py (but the broker's wire, which waits
for the host-layer slice) and the mesh-exchange cases of
tests/test_sharded_parity.py run through both packages: the reference's
LocalCluster on one device per agent or on its 8 virtual CPU devices
(tests/conftest.py), the port's on the CPU with n co-located shards
(PIXIE_TORCH_VIRTUAL_SHARDS = 8).  Partition ids and exchanged buckets must
match exactly; joins as sorted frames.

Beyond them, the plain versions of kernels X1 and X2 (ops/repartition.py)
against the reference: X1's hash against `partition_ids` over int64 keys
(values above 2^63 as uint64 too), dictionary keys with nulls, an empty
dictionary, several keys and a width that is not a power of two; X2's
stable bucket order against `mesh_repartition`; extreme skew; and a
capacity fault, which the exchange's row-conservation check refuses.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
import pixie_tpu.matview.maintainer  # noqa: F401  (defines PL_MATVIEW_ENABLED)
import pixie_tpu.trace  # noqa: F401  (defines PL_TRACING_ENABLED)
from pixie_tpu import flags as ref_flags
from pixie_tpu.engine.executor import HostBatch as RefHostBatch
from pixie_tpu.parallel import DistributedPlanner as RefPlanner
from pixie_tpu.parallel import LocalCluster as RefCluster
from pixie_tpu.parallel import repartition as ref_rp
from pixie_tpu.parallel import spmd as ref_spmd
from pixie_tpu.plan.plan import JoinOp, MemorySinkOp, MemorySourceOp, Plan
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.table.dictionary import Dictionary as RefDictionary
from pixie_tpu.types import DataType as DT, Relation as RefRelation

import pixie_tpu_torch.interop as interop
from pixie_tpu_torch import flags as port_flags
from pixie_tpu_torch import metrics
from pixie_tpu_torch.engine.executor import HostBatch, PlanExecutor
from pixie_tpu_torch.ops import repartition as rk
from pixie_tpu_torch.parallel import DistributedPlanner, LocalCluster
from pixie_tpu_torch.parallel import repartition as rp
from pixie_tpu_torch.parallel.spmd import make_mesh, per_shard_valid
from pixie_tpu_torch.plan.plan import PartitionSinkOp
from pixie_tpu_torch.status import Internal
from pixie_tpu_torch.table import TableStore
from pixie_tpu_torch.table.dictionary import Dictionary
from pixie_tpu_torch.types import Relation

NOW = 1_700_000_000_000_000_000
N_DEV = 8


@pytest.fixture(autouse=True)
def _mesh_env():
    saved = {f: ref_flags.get(f) for f in ("PL_MATVIEW_ENABLED", "PL_TRACING_ENABLED")}
    for f in saved:
        ref_flags.set_for_testing(f, False)
    port_views = port_flags.get("PL_MATVIEW_ENABLED")
    port_flags.set_for_testing("PL_MATVIEW_ENABLED", False)
    port_flags.set_for_testing("PIXIE_TORCH_VIRTUAL_SHARDS", N_DEV)
    yield
    port_flags.set_for_testing("PIXIE_TORCH_VIRTUAL_SHARDS", 1)
    for f, v in saved.items():
        ref_flags.set_for_testing(f, v)
    port_flags.set_for_testing("PL_MATVIEW_ENABLED", port_views)


# -------------------------------------------------------------- hash basics
def _hbs(keys, vals, dict_order=None):
    """(port HostBatch, reference HostBatch) of a string key k and int v."""
    order = dict_order or sorted(set(keys))
    d, rd = Dictionary(order), RefDictionary(order)
    v = np.asarray(vals, dtype=np.int64)
    return (HostBatch({"k": DT.STRING, "v": DT.INT64}, {"k": d},
                      {"k": d.encode(list(keys)), "v": v.copy()}),
            RefHostBatch({"k": DT.STRING, "v": DT.INT64}, {"k": rd},
                         {"k": rd.encode(list(keys)), "v": v.copy()}))


def test_partition_ids_stable_across_code_spaces():
    """tests/test_repartition.py: one VALUE lands in one partition whatever
    each agent's dictionary codes — and the partition is the reference's."""
    keys = ["a", "b", "c", "a", "d"]
    hb1, r1 = _hbs(keys, range(5), dict_order=["a", "b", "c", "d"])
    hb2, _r2 = _hbs(keys, range(5), dict_order=["d", "c", "b", "a"])
    p1 = rp.partition_ids(hb1, ["k"], 4)
    np.testing.assert_array_equal(p1, rp.partition_ids(hb2, ["k"], 4))
    np.testing.assert_array_equal(p1, ref_rp.partition_ids(r1, ["k"], 4))
    assert p1[0] == p1[3]


def test_split_host_batch_partitions_every_row():
    rng = np.random.default_rng(0)
    keys = [f"k{i % 13}" for i in range(500)]
    hb, ref = _hbs(keys, rng.integers(0, 100, 500))
    part = rp.partition_ids(hb, ["k"], 3)
    buckets = rp.split_host_batch(hb, part, 3)
    want = ref_rp.split_host_batch(ref, ref_rp.partition_ids(ref, ["k"], 3), 3)
    assert sum(b.num_rows for b in buckets) == 500
    seen = {}
    for p, (b, w) in enumerate(zip(buckets, want)):
        for c in ("k", "v"):
            np.testing.assert_array_equal(b.cols[c], w.cols[c])
        for code in np.unique(b.cols["k"]):
            assert seen.setdefault(b.dicts["k"].decode([code])[0], p) == p


# ------------------------------------------------------------ X1's hash
def test_splitmix64_plain_equals_numpy_above_2_63():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.integers(0, 1 << 63, 1000, dtype=np.uint64) | np.uint64(1 << 63),
                        np.array([0, 1, (1 << 64) - 1, 1 << 63], dtype=np.uint64),
                        rng.integers(0, 1 << 63, 1000, dtype=np.uint64)])
    got = rk.splitmix64_plain(torch.from_numpy(x.view(np.int64))).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, ref_rp._splitmix64(x))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 8, 1000, (1 << 31) - 1])
def test_unsigned_modulo_plain(n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, np.iinfo(np.uint64).max, 4000, dtype=np.uint64, endpoint=True)
    got = rk.umod_plain(torch.from_numpy(x.view(np.int64)), n).numpy()
    np.testing.assert_array_equal(got, (x % np.uint64(n)).astype(np.int64))


def _x1_part(hb, keys, n_dev):
    """X1's plain version over one shard holding all of hb's rows
    (padded to a multiple of n_dev), → part of the valid rows."""
    rows = hb.num_rows
    per = -(-rows // n_dev)
    cols = {k: rp._upload_padded(np.asarray(hb.cols[k]), per * n_dev, torch.device("cpu"))
            for k in keys}
    luts = rp._device_key_luts(hb, keys, torch.device("cpu"))
    nv = per_shard_valid(rows, per * n_dev, n_dev)
    part, counts, tiles = rk.partition_count([(cols[k], luts.get(k)) for k in keys], nv, n_dev)
    part = part.numpy()
    assert (part[rows:] == n_dev).all()
    np.testing.assert_array_equal(counts.numpy(), tiles.numpy().sum(1))
    for s in range(n_dev):
        seg = part[s * per: s * per + nv[s]]
        np.testing.assert_array_equal(counts.numpy()[s], np.bincount(seg, minlength=n_dev))
    return part[:rows]


@pytest.mark.parametrize("n_dev", [4, 8, 3])
def test_x1_plain_equals_partition_ids_int_keys(n_dev):
    """int64 keys (negative ones: uint64 values above 2^63), a float key cast
    as the reference casts it, and two keys at once."""
    rng = np.random.default_rng(5)
    n = 5000
    a = rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64)
    a[:5] = [np.iinfo(np.int64).min, -1, 0, 1, np.iinfo(np.int64).max]
    b = rng.normal(0, 1e6, n)
    cols = {"a": a, "b": b}
    dtypes = {"a": DT.INT64, "b": DT.FLOAT64}
    hb = HostBatch(dtypes, {}, {k: v.copy() for k, v in cols.items()})
    ref = RefHostBatch(dtypes, {}, {k: v.copy() for k, v in cols.items()})
    for keys in (["a"], ["b"], ["a", "b"]):
        np.testing.assert_array_equal(_x1_part(hb, keys, n_dev),
                                      ref_rp.partition_ids(ref, keys, n_dev))


def test_x1_plain_equals_partition_ids_dict_keys_with_nulls():
    rng = np.random.default_rng(6)
    n = 3000
    vals = [f"svc-{i}" for i in range(37)]
    codes = rng.integers(-1, 37, n).astype(np.int32)  # -1: null
    other = rng.integers(0, 1 << 40, n).astype(np.int64)
    d, rd = Dictionary(vals), RefDictionary(vals)
    dtypes = {"s": DT.STRING, "o": DT.INT64}
    hb = HostBatch(dtypes, {"s": d}, {"s": codes.copy(), "o": other.copy()})
    ref = RefHostBatch(dtypes, {"s": rd}, {"s": codes.copy(), "o": other.copy()})
    for keys in (["s"], ["s", "o"], ["o", "s"]):
        np.testing.assert_array_equal(_x1_part(hb, keys, 8),
                                      ref_rp.partition_ids(ref, keys, 8))


def test_x1_plain_empty_dictionary_hashes_null():
    """An empty dictionary: every code is null, as the reference's device
    key function guards it."""
    n = 100
    codes = np.full(n, -1, dtype=np.int32)
    v = np.arange(n, dtype=np.int64)
    dtypes = {"s": DT.STRING, "v": DT.INT64}
    hb = HostBatch(dtypes, {"s": Dictionary()}, {"s": codes.copy(), "v": v.copy()})
    ref = RefHostBatch(dtypes, {"s": RefDictionary()}, {"s": codes.copy(), "v": v.copy()})
    got = _x1_part(hb, ["s"], 4)
    np.testing.assert_array_equal(got, ref_rp.partition_ids(ref, ["s"], 4))
    assert len(set(got.tolist())) == 1
    import jax.numpy as jnp

    key_fn = ref_rp._device_key_fn(ref, ["s", "v"])
    want = np.asarray(key_fn({"s": jnp.asarray(codes), "v": jnp.asarray(v)}) % 4)
    np.testing.assert_array_equal(_x1_part(hb, ["s", "v"], 4), want)


def test_x1_tile_counts_cover_many_tiles():
    """A shard longer than one tile: X1's per-tile counts add up to the
    shard's counts, tile by tile as a numpy bincount gives them."""
    rng = np.random.default_rng(9)
    n_dev, per = 4, 3 * rk.TILE + 17
    col = torch.from_numpy(rng.integers(0, 1 << 30, n_dev * per).astype(np.int64))
    nv = np.array([per, per, per - 5000, 0], dtype=np.int64)
    part, counts, tiles = rk.partition_count([(col, None)], nv, n_dev)
    part = part.numpy().reshape(n_dev, per)
    for s in range(n_dev):
        for t in range(tiles.shape[1]):
            seg = part[s, t * rk.TILE: (t + 1) * rk.TILE]
            np.testing.assert_array_equal(tiles[s, t].numpy(),
                                          np.bincount(seg, minlength=n_dev + 1)[:n_dev])
    assert counts.numpy().sum() == nv.sum()


# -------------------------------------------------------- X2's stable order
def test_x2_plain_equals_mesh_repartition_stable_order():
    """X2's plain version lays every column out as the reference's
    mesh_repartition (its all_to_all included) does: block (p, i) holds
    shard i's rows for partition p in row order."""
    rng = np.random.default_rng(1)
    n_dev, per = N_DEV, 64
    total = n_dev * per
    keys = rng.integers(0, 1000, total).astype(np.int64)
    vals = rng.integers(0, 1 << 20, total).astype(np.int64)
    fn = ref_rp.mesh_repartition(ref_spmd.make_mesh(n_dev), "agents",
                                 key_fn=lambda cols: cols["key"],
                                 n_cols={"key": None, "val": None})
    nv = np.full(n_dev, per, dtype=np.int64)
    nv[-1] = 40  # a short last shard
    want, want_counts = fn({"key": keys, "val": vals}, nv)
    want_counts = np.asarray(want_counts).reshape(n_dev, n_dev)
    want = {k: np.asarray(v).reshape(n_dev, n_dev, per) for k, v in want.items()}
    # the same partition function (key % n_dev) given to X2 as its part ids
    part = torch.from_numpy((keys % n_dev).astype(np.int32)).view(n_dev, per).clone()
    part[torch.arange(per).view(1, per) >= torch.from_numpy(nv).view(n_dev, 1)] = n_dev
    part = part.view(-1)
    counts = torch.stack([torch.bincount(part.view(n_dev, per)[s].long(),
                                         minlength=n_dev + 1)[:n_dev] for s in range(n_dev)])
    tiles = counts.view(n_dev, 1, n_dev)
    cap = int(counts.max())
    outs, recv = rk.partition_scatter(part, tiles, counts,
                                      [torch.from_numpy(keys), torch.from_numpy(vals)],
                                      n_dev, cap)
    got_counts = recv.numpy().reshape(n_dev, n_dev)
    np.testing.assert_array_equal(got_counts, want_counts)
    for name, out in zip(("key", "val"), outs):
        blocks = out.numpy().reshape(n_dev, n_dev, cap)
        for p in range(n_dev):
            for i in range(n_dev):
                c = got_counts[p, i]
                np.testing.assert_array_equal(blocks[p, i, :c], want[name][p, i, :c])
                if name == "key":
                    assert np.all(blocks[p, i, :c] % n_dev == p)


#: the X2 card tests' column dtypes: widths 1, 2, 4 and 8 in turn
_MIXED = [np.uint8, np.int16, np.float32, np.int64, np.bool_, np.int32, np.float64]


def test_x2_plain_equals_mesh_repartition_mixed_widths():
    """At 3 partitions, 17 columns of widths 1, 2, 4 and 8: X2's plain
    version lays every column out as mesh_repartition does, and its recv
    equals the reference's counts."""
    rng = np.random.default_rng(2)
    n_dev, per = 3, 700
    total = n_dev * per
    cols = {}
    for c in range(17):
        dt = _MIXED[c % len(_MIXED)]
        if dt == np.bool_:
            cols[f"c{c}"] = rng.random(total) < 0.5
        elif np.issubdtype(dt, np.floating):
            cols[f"c{c}"] = rng.normal(size=total).astype(dt)
        else:
            cols[f"c{c}"] = rng.integers(np.iinfo(dt).min, np.iinfo(dt).max, total, dtype=dt)
    keys = cols["c3"]  # the int64 column
    fn = ref_rp.mesh_repartition(ref_spmd.make_mesh(n_dev), "agents",
                                 key_fn=lambda cs: cs["c3"], n_cols={k: None for k in cols})
    nv = np.array([per, per - 9, per // 2], dtype=np.int64)
    want, want_counts = fn(cols, nv)
    want_counts = np.asarray(want_counts).reshape(n_dev, n_dev)
    part = torch.from_numpy((keys % n_dev).astype(np.int32)).view(n_dev, per).clone()
    part[torch.arange(per).view(1, per) >= torch.from_numpy(nv).view(n_dev, 1)] = n_dev
    part = part.view(-1)
    counts = torch.stack([torch.bincount(part.view(n_dev, per)[s].long(),
                                         minlength=n_dev + 1)[:n_dev] for s in range(n_dev)])
    cap = int(counts.max())
    outs, recv = rk.partition_scatter(part, counts.view(n_dev, 1, n_dev), counts,
                                      [torch.from_numpy(v) for v in cols.values()], n_dev, cap)
    got_counts = recv.numpy().reshape(n_dev, n_dev)
    np.testing.assert_array_equal(got_counts, want_counts)
    assert got_counts.sum() == nv.sum()
    for name, out in zip(cols, outs):
        assert out.numpy().dtype == cols[name].dtype
        blocks = out.numpy().reshape(n_dev, n_dev, cap)
        ref = np.asarray(want[name]).reshape(n_dev, n_dev, per)
        for p in range(n_dev):
            for i in range(n_dev):
                c = got_counts[p, i]
                np.testing.assert_array_equal(blocks[p, i, :c], ref[p, i, :c])


def test_mesh_repartition_routes_by_key():
    """tests/test_repartition.py: every row lands on its partition, none
    lost, the (key, val) multiset preserved — X1 and X2 end to end."""
    rng = np.random.default_rng(1)
    n = 512
    keys = rng.integers(0, 1000, n).astype(np.int64)
    vals = rng.integers(0, 1 << 20, n).astype(np.int64)
    hb = HostBatch({"key": DT.INT64, "val": DT.INT64}, {}, {"key": keys, "val": vals})
    out = rp.mesh_partition_exchange(hb, ["key"], N_DEV, make_mesh(N_DEV, device="cpu"))
    part = rp.partition_ids(hb, ["key"], N_DEV)
    pairs = []
    for p, b in enumerate(out):
        assert set(part[np.isin(keys, b.cols["key"])]) <= {p}
        pairs.extend(zip(b.cols["key"].tolist(), b.cols["val"].tolist()))
    assert sorted(pairs) == sorted(zip(keys.tolist(), vals.tolist()))


def test_mesh_partition_exchange_matches_host_exchange(rng):
    """tests/test_repartition.py: the in-mesh exchange assigns every row the
    host exchange's partition; each partition's rows equal the reference's
    mesh exchange's, in the same order."""
    n = 1000
    keys = rng.choice(["a", "b", "c", "d", "e", "f"], n).tolist()
    hb, ref = _hbs(keys, np.arange(n))
    got = rp.mesh_partition_exchange(hb, ["k"], 4, make_mesh(4, device="cpu"))
    host = rp.split_host_batch(hb, rp.partition_ids(hb, ["k"], 4), 4)
    want = ref_rp.mesh_partition_exchange(ref, ["k"], 4, ref_spmd.make_mesh(4))
    assert sum(b.num_rows for b in got) == n
    for p in range(4):
        for c in ("k", "v"):
            np.testing.assert_array_equal(got[p].cols[c], want[p].cols[c])
        gw = sorted(zip(got[p].cols["k"].tolist(), got[p].cols["v"].tolist()))
        ww = sorted(zip(host[p].cols["k"].tolist(), host[p].cols["v"].tolist()))
        assert gw == ww, f"partition {p} differs"
    skew = [v for _k, n_, _l, v in metrics.snapshot() if n_ == "px_partition_skew_frac"]
    assert skew and skew[0] >= 1.0


def test_mesh_exchange_extreme_skew_conserves_rows(rng):
    """tests/test_sharded_parity.py: every row on ONE key (cap = the shard
    size) survives the two-pass exchange intact."""
    n = 777
    cols = {"k": np.full(n, 12345, dtype=np.int64),
            "v": rng.integers(0, 1 << 20, n).astype(np.int64)}
    hb = HostBatch({"k": DT.INT64, "v": DT.INT64}, {}, cols)
    out = rp.mesh_partition_exchange(hb, ["k"], 4, make_mesh(4, device="cpu"))
    sizes = [b.num_rows for b in out]
    assert sum(sizes) == n and sorted(sizes)[-1] == n
    got = sorted(np.concatenate([b.cols["v"] for b in out]).tolist())
    assert got == sorted(cols["v"].tolist())


def test_mesh_exchange_capacity_fault_fails_loudly(monkeypatch, rng):
    """A bucket capacity below the largest bucket must not drop rows
    quietly: the received counts fall short and the exchange raises."""
    real = rk.partition_scatter

    def short_cap(part, tiles, counts, cols, n_dev, cap):
        return real(part, tiles, counts, cols, n_dev, max(1, cap - 1))

    monkeypatch.setattr(rk, "partition_scatter", short_cap)
    hb = HostBatch({"k": DT.INT64}, {}, {"k": rng.integers(0, 9, 300).astype(np.int64)})
    with pytest.raises(Internal, match="lost rows"):
        rp.mesh_partition_exchange(hb, ["k"], 4, make_mesh(4, device="cpu"))


# ------------------------------------------------------------ joins
def _join_data(n_left=4000, n_right=3000, n_agents=2, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_agents):
        out.append({
            "left_t": {"time_": NOW + np.arange(n_left, dtype=np.int64),
                       "k": np.array([f"key{rng.integers(0, 200)}" for _ in range(n_left)]),
                       "lv": rng.integers(0, 1000, n_left).astype(np.int64)},
            "right_t": {"time_": NOW + np.arange(n_right, dtype=np.int64),
                        "k": np.array([f"key{rng.integers(0, 200)}" for _ in range(n_right)]),
                        "rv": rng.integers(0, 1000, n_right).astype(np.int64)}})
    return out


def _stores(data):
    """({agent: reference store}, {agent: port store}) holding `data`."""
    rels = {"left_t": RefRelation.of(("time_", DT.TIME64NS), ("k", DT.STRING), ("lv", DT.INT64)),
            "right_t": RefRelation.of(("time_", DT.TIME64NS), ("k", DT.STRING),
                                      ("rv", DT.INT64))}
    ref, port = {}, {}
    for i, tables in enumerate(data):
        r, p = RefStore(), TableStore()
        for name, cols in tables.items():
            r.create(name, rels[name]).write({k: v.copy() for k, v in cols.items()})
            p.create(name, Relation.from_dict(rels[name].to_dict())).write(
                {k: v.copy() for k, v in cols.items()})
        ref[f"pem{i}"], port[f"pem{i}"] = r, p
    return ref, port


def _join_plan(how="inner"):
    p = Plan()
    left = p.add(MemorySourceOp(table="left_t", columns=["k", "lv"]))
    right = p.add(MemorySourceOp(table="right_t", columns=["k", "rv"]))
    j = p.add(JoinOp(how=how, left_on=["k"], right_on=["k"],
                     output=[("left", "k", "k"), ("left", "lv", "lv"), ("right", "rv", "rv")]),
              parents=[left, right])
    p.add(MemorySinkOp(name="out"), parents=[j])
    return p


def _oracle(data, how):
    def frame(t, cols):
        return pd.concat([pd.DataFrame({c: d[t][c] for c in cols}) for d in data],
                         ignore_index=True)

    return frame("left_t", ["k", "lv"]).merge(frame("right_t", ["k", "rv"]), on="k", how=how)


def _sorted(df):
    return df.fillna(-1).sort_values(["k", "lv", "rv"]).reset_index(drop=True)


def assert_join(got, want_df):
    g, w = _sorted(got.to_pandas()), _sorted(want_df)
    assert len(g) == len(w)
    np.testing.assert_array_equal(g["k"].to_numpy(), w["k"].to_numpy())
    for c in ("lv", "rv"):
        np.testing.assert_array_equal(g[c].to_numpy(np.float64), w[c].to_numpy(np.float64))


def test_planner_emits_join_stage():
    """tests/test_repartition.py: two producers → one join stage of two
    partitions, partition sinks for both sides on every agent, and the same
    split as the reference's planner."""
    ref_stores, stores = _stores(_join_data())
    cluster = LocalCluster(stores, device="cpu", n_devices_per_agent=1)
    dp = DistributedPlanner(cluster.spec).plan(interop.plan_from_dict(_join_plan().to_dict()))
    want = RefPlanner(RefCluster(ref_stores, n_devices_per_agent=1).spec).plan(_join_plan())
    assert len(dp.join_stages) == 1 and dp.join_stages[0].n_parts == 2
    assert dp.to_dict() == want.to_dict()
    for name, plan in dp.agent_plans.items():
        assert len([op for op in plan.ops() if isinstance(op, PartitionSinkOp)]) == 2, name
    st = dp.join_stages[0]
    for prefix in (st.left_prefix, st.right_prefix):
        for p in range(st.n_parts):
            assert f"{prefix}{p}" in dp.channels


@pytest.mark.parametrize("how", ["inner", "left", "outer"])
def test_repartition_join_matches_reference(how):
    """tests/test_repartition.py: the host exchange, partition joins and the
    merger's union equal pandas and the reference's cluster."""
    data = _join_data()
    ref_stores, stores = _stores(data)
    plan = _join_plan(how)
    got = LocalCluster(stores, device="cpu", n_devices_per_agent=1).execute(
        interop.plan_from_dict(plan.to_dict()))["out"]
    want = RefCluster(ref_stores, n_devices_per_agent=1).execute(plan)["out"]
    assert_join(got, _oracle(data, how))
    assert_join(got, want.to_pandas())


def test_single_producer_join_skips_repartition():
    ref_stores, stores = _stores(_join_data(n_agents=1))
    cluster = LocalCluster(stores, device="cpu", n_devices_per_agent=1)
    plan = interop.plan_from_dict(_join_plan().to_dict())
    assert not DistributedPlanner(cluster.spec).plan(plan).join_stages
    got = cluster.execute(plan)["out"]
    want = RefCluster(ref_stores, n_devices_per_agent=1).execute(_join_plan())["out"]
    assert got.num_rows > 0
    assert_join(got, want.to_pandas())


def test_join_stage_uses_mesh_shuffle():
    """tests/test_repartition.py: agents with 2-shard meshes exchange both
    join sides in the mesh (X1, X2), and the join still matches."""
    data = _join_data()
    ref_stores, stores = _stores(data)
    res = LocalCluster(stores, device="cpu", n_devices_per_agent=2).execute(
        interop.plan_from_dict(_join_plan().to_dict()))["out"]
    want = RefCluster(ref_stores, n_devices_per_agent=2).execute(_join_plan())["out"]
    assert_join(res, _oracle(data, "inner"))
    agents = res.exec_stats["agents"]
    assert all(st.get("mesh_shuffles", 0) >= 2 for st in agents.values())
    assert res.exec_stats["transfer"]["mesh_shuffles"] == \
        want.exec_stats["transfer"]["mesh_shuffles"]


def test_mixed_mesh_and_host_exchange_producers():
    """One agent exchanges in its mesh and one on the host (its mesh is
    narrower than the stage): partitions agree, the join is exact."""
    data = _join_data()
    _ref_stores, stores = _stores(data)
    cluster = LocalCluster(stores, device="cpu", n_devices_per_agent=4)
    cluster.spec.agents[1].n_devices = 1
    res = cluster.execute(interop.plan_from_dict(_join_plan().to_dict()))["out"]
    assert_join(res, _oracle(data, "inner"))
    agents = res.exec_stats["agents"]
    assert agents["pem0"].get("mesh_shuffles", 0) == 2
    assert agents["pem1"].get("mesh_shuffles", 0) == 0


def test_shuffled_join_dict_keys_matches_single_device():
    """tests/test_sharded_parity.py: one agent with an 8-shard mesh widens the
    shuffle to 8 partitions; string keys route by value and the joined rows
    equal the single-device join's."""
    rng = np.random.default_rng(3)
    n = 4000
    data = [{"left_t": {"time_": NOW + np.arange(n, dtype=np.int64),
                        "k": np.array([f"key{rng.integers(0, 300)}" for _ in range(n)]),
                        "lv": rng.integers(0, 1000, n).astype(np.int64)},
             "right_t": {"time_": NOW + np.arange(n, dtype=np.int64),
                         "k": np.array([f"key{rng.integers(0, 300)}" for _ in range(n)]),
                         "rv": rng.integers(0, 1000, n).astype(np.int64)}}]
    ref_stores, stores = _stores(data)
    plan = interop.plan_from_dict(_join_plan().to_dict())
    cluster = LocalCluster(stores, device="cpu", n_devices_per_agent=N_DEV)
    dp = cluster.planner.plan(plan)
    assert dp.join_stages and dp.join_stages[0].n_parts == N_DEV
    res = cluster.execute(plan)["out"]
    assert sum(s.get("mesh_shuffles", 0) for s in res.exec_stats["agents"].values()) >= 2
    single = PlanExecutor(plan, stores["pem0"], device="cpu", mesh=None).run()["out"]
    assert_join(res, single.to_pandas())
    want = RefCluster(ref_stores, n_devices_per_agent=N_DEV).execute(_join_plan())["out"]
    assert_join(res, want.to_pandas())


def test_planner_keeps_agent_count_without_explicit_mesh():
    """tests/test_sharded_parity.py: the default (auto) mesh does not widen
    the shuffle — a single agent plans no join stage."""
    ts = TableStore()
    for name, col in (("left_t", "lv"), ("right_t", "rv")):
        t = ts.create(name, Relation.from_dict(
            RefRelation.of(("k", DT.INT64), (col, DT.INT64)).to_dict()))
        t.write({"k": np.arange(100), col: np.arange(100)})
    p = Plan()
    left = p.add(MemorySourceOp(table="left_t"))
    right = p.add(MemorySourceOp(table="right_t"))
    j = p.add(JoinOp(how="inner", left_on=["k"], right_on=["k"],
                     output=[("left", "k", "k"), ("left", "lv", "lv"), ("right", "rv", "rv")]),
              parents=[left, right])
    p.add(MemorySinkOp(name="out"), parents=[j])
    cluster = LocalCluster({"pem0": ts}, device="cpu")
    assert not cluster.planner.plan(interop.plan_from_dict(p.to_dict())).join_stages


def test_run_agent_stream_yields_partition_buckets():
    """The chunk-stream form of an agent plan ships one chunk per bucket, the
    buckets run_agent returns."""
    _ref_stores, stores = _stores(_join_data())
    cluster = LocalCluster(stores, device="cpu", n_devices_per_agent=2)
    dp = cluster.planner.plan(interop.plan_from_dict(_join_plan().to_dict()))
    plan = dp.agent_plans["pem0"]
    got = dict(PlanExecutor(plan, stores["pem0"], device="cpu",
                            mesh=make_mesh(2, device="cpu")).run_agent_stream())
    want = PlanExecutor(plan, stores["pem0"], device="cpu",
                        mesh=make_mesh(2, device="cpu")).run_agent()
    assert set(got) == set(want) and len(got) == 4
    for cid in want:
        for c in want[cid].cols:
            np.testing.assert_array_equal(got[cid].cols[c], want[cid].cols[c])


# ------------------------------------------- the exchange across processes
#: the two-rank exchange: 2 ranks x 2 shards of an odd row count (padded to
#: split over the processes), each shard's valid rows
X_RANKS, X_SHARDS, X_PER = 2, 2, 301
X_VALID = (301, 250, 301, 0)
X_DICT = ["svc-a", "svc-b", "svc-c", "svc-d", "svc-e"]
X_KEYS = {"int": ["k"], "dict_and_int": ["svc", "k"]}

X_WORKER = r'''
import json, sys
import numpy as np
import torch

from pixie_tpu_torch.ops.repartition import value_hash_lut
from pixie_tpu_torch.parallel import multihost
from pixie_tpu_torch.parallel.repartition import mesh_bucket_counts, mesh_repartition

out_dir, per, valid, dict_size, key_sets = (sys.argv[1], int(sys.argv[2]),
                                            json.loads(sys.argv[3]), int(sys.argv[4]),
                                            json.loads(sys.argv[5]))
assert multihost.init_multihost(device="cpu")
mesh = multihost.global_mesh(device="cpu")
lo, hi = mesh.local_slice

def shard(g):
    rng = np.random.default_rng(700 + g)
    return {"k": rng.integers(0, 1000, per).astype(np.int64),
            "svc": rng.integers(-1, dict_size, per).astype(np.int32),
            "v": rng.normal(size=per), "b": rng.random(per) < 0.5}

mine = [shard(g) for g in range(lo, hi)]
cols = {k: torch.from_numpy(np.stack([m[k] for m in mine])) for k in mine[0]}
names = [f"svc-{c}" for c in "abcde"][:dict_size]
luts = {"svc": torch.from_numpy(value_hash_lut(names))}
save, doc = {}, {}
for label, keys in key_sets.items():
    ex = mesh_repartition(mesh, keys, luts)(cols, np.asarray(valid))
    save[f"{label}/counts"] = ex.counts
    for j in range(hi - lo):
        for name in cols:
            save[f"{label}/{name}/{j}"] = ex.rows(j)[name]
    _part, counts = mesh_bucket_counts(mesh, keys, luts)(cols, np.asarray(valid))
    save[f"{label}/bucket_counts"] = counts.numpy()
    doc[label] = {"sent": ex.sent_bytes, "recv": ex.recv_bytes}
doc["stats"] = multihost.exec_stats()
np.savez(f"{out_dir}/rank{mesh.rank}.npz", **save)
print(json.dumps(doc), flush=True)
multihost.shutdown()
'''


def _x_shard(g):
    rng = np.random.default_rng(700 + g)
    return {"k": rng.integers(0, 1000, X_PER).astype(np.int64),
            "svc": rng.integers(-1, len(X_DICT), X_PER).astype(np.int32),
            "v": rng.normal(size=X_PER), "b": rng.random(X_PER) < 0.5}


@pytest.fixture(scope="module")
def x_job(tmp_path_factory):
    """One gloo job of 2 CPU ranks x 2 shards running both key sets."""
    import json

    from pixie_tpu_torch.parallel import multihost, shard_bench

    out = tmp_path_factory.mktemp("exchange")
    script = out / "worker.py"
    script.write_text(X_WORKER)
    argv = [str(script), str(out), str(X_PER), json.dumps(list(X_VALID)), str(len(X_DICT)),
            json.dumps(X_KEYS)]
    outs = multihost.launch(lambda rank: argv, X_RANKS, shard_bench._worker_env(X_SHARDS),
                            180.0)
    docs = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    return docs, [dict(np.load(out / f"rank{r}.npz")) for r in range(X_RANKS)]


def _x_reference(keys):
    """The reference's mesh_repartition and mesh_bucket_counts over its 4
    virtual devices on the same rows: → (blocks [dest, source, per] by
    column, counts [dest, source], bucket counts [sender, bucket])."""
    n_dev = X_RANKS * X_SHARDS
    shards = [_x_shard(g) for g in range(n_dev)]
    cols = {k: np.concatenate([s[k] for s in shards]) for k in shards[0]}
    d = RefDictionary(X_DICT)
    hb = RefHostBatch({"k": DT.INT64, "svc": DT.STRING}, {"svc": d},
                      {"k": cols["k"], "svc": cols["svc"]})
    key_fn = ref_rp._device_key_fn(hb, keys)
    mesh = ref_spmd.make_mesh(n_dev)
    nv = np.asarray(X_VALID, dtype=np.int64)
    n_cols = {k: None for k in cols}
    got, counts = ref_rp.mesh_repartition(mesh, "agents", key_fn, n_cols)(cols, nv)
    blocks = {k: np.asarray(v).reshape(n_dev, n_dev, X_PER) for k, v in got.items()}
    _marked, bucket = ref_rp.mesh_bucket_counts(mesh, "agents", key_fn, n_cols)(cols, nv)
    return (blocks, np.asarray(counts).reshape(n_dev, n_dev),
            np.asarray(bucket).reshape(n_dev, n_dev))


@pytest.mark.parametrize("label", list(X_KEYS))
def test_mesh_repartition_across_ranks_equals_reference(x_job, label):
    """Each rank's received rows for every (destination, source) equal the
    reference's block up to its count, in order, with its counts; no row
    past a count arrives."""
    _docs, states = x_job
    blocks, counts, _bucket = _x_reference(X_KEYS[label])
    n_dev = X_RANKS * X_SHARDS
    assert counts.sum() == sum(X_VALID)
    for r, st in enumerate(states):
        lo = r * X_SHARDS
        np.testing.assert_array_equal(st[f"{label}/counts"], counts[lo:lo + X_SHARDS])
        for j in range(X_SHARDS):
            for name, want in blocks.items():
                got = st[f"{label}/{name}/{j}"]
                assert len(got) == counts[lo + j].sum()
                at = 0
                for s in range(n_dev):
                    c = counts[lo + j, s]
                    np.testing.assert_array_equal(got[at:at + c], want[lo + j, s, :c])
                    at += c


@pytest.mark.parametrize("label", list(X_KEYS))
def test_mesh_bucket_counts_across_ranks_equals_reference(x_job, label):
    _docs, states = x_job
    _blocks, _counts, bucket = _x_reference(X_KEYS[label])
    for r, st in enumerate(states):
        lo = r * X_SHARDS
        np.testing.assert_array_equal(st[f"{label}/bucket_counts"], bucket[lo:lo + X_SHARDS])


def test_exchange_across_ranks_moves_counted_rows_only(x_job):
    """Besides the counts' all_to_all_single, one a column an exchange; the
    bytes sent are the valid rows' (what one rank sends, another receives)."""
    docs, _states = x_job
    width = 8 + 4 + 8 + 1
    for label in X_KEYS:
        assert sum(d[label]["sent"] for d in docs) == sum(X_VALID) * width
        assert sum(d[label]["recv"] for d in docs) == sum(X_VALID) * width
    for d in docs:
        assert d["stats"]["exchanges"] == 2 and d["stats"]["all_to_all_calls"] == 2 * 4
        assert d["stats"]["staged_bytes"] == 0
