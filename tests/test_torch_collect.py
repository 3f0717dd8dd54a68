"""The port's collectors (collect/: core, seq_gen, replay, proc_stats,
access_log, schemas) against the reference's.

The cases of tests/test_collect.py and tests/test_access_log.py run on the
port; then the canonical relations equal the reference's relation by
relation (names, types, semantic types), and seq_gen and replay write the
same rows as the reference's connectors (exactly; seq_gen's and a
rewritten replay's time_ is the arrival clock and is compared only as
non-decreasing)."""
from __future__ import annotations

import os
import time

import numpy as np
import pytest

import pixie_tpu  # noqa: F401  (JAX first: x64 on)
from pixie_tpu.collect import Collector as RefCollector
from pixie_tpu.collect import ReplayConnector as RefReplay
from pixie_tpu.collect import SeqGenConnector as RefSeqGen
from pixie_tpu.collect.schemas import all_schemas as ref_all_schemas
from pixie_tpu.types import DataType as RDT, Relation as RRel

from pixie_tpu_torch.collect import (
    Collector,
    FrequencyManager,
    NetworkStatsConnector,
    ProcessStatsConnector,
    ReplayConnector,
    SeqGenConnector,
    SourceConnector,
    TableSpec,
)
from pixie_tpu_torch.collect.access_log import AccessLogConnector, parse_line
from pixie_tpu_torch.collect.schemas import SCHEMAS, all_schemas
from pixie_tpu_torch.compiler import compile_pxl
from pixie_tpu_torch.engine import execute_plan
from pixie_tpu_torch.status import InvalidArgument
from pixie_tpu_torch.types import DataType as DT, Relation


def _col(table, name) -> np.ndarray:
    return np.concatenate([rb.columns[name][: rb.num_valid] for rb, _, _ in table.cursor()])


def test_seq_gen_synchronous():
    c = Collector()
    c.register(SeqGenConnector(rows_per_transfer=100, total_rows=250))
    assert c.store.has("seq0") and c.store.has("seq1")
    total = sum(c.transfer_once() for _ in range(5))
    assert total == 500  # 250 rows x 2 tables; exhausted after 3 transfers
    t = c.store.table("seq0")
    assert t.stats()["rows_written"] == 250
    xs = _col(t, "x")
    np.testing.assert_array_equal(np.sort(xs), np.arange(250))
    np.testing.assert_array_equal(np.sort(_col(t, "xsquared")), np.sort(xs * xs))
    assert c.connectors() == []  # exhausted source removed


def test_replay_connector_rewrites_time():
    rel = Relation.of(("time_", DT.TIME64NS), ("v", DT.INT64))
    data = {"time_": np.arange(1000, dtype=np.int64) * 1000,
            "v": np.arange(1000, dtype=np.int64)}
    c = Collector()
    c.register(ReplayConnector("replayed", rel, data=data, rows_per_transfer=300))
    t0 = time.time_ns()
    while c.transfer_once():
        pass
    t = c.store.table("replayed")
    assert t.stats()["rows_written"] == 1000
    assert _col(t, "time_").min() >= t0  # rewritten to arrival time
    np.testing.assert_array_equal(np.sort(_col(t, "v")), np.arange(1000))


def test_replay_from_generator():
    rel = Relation.of(("time_", DT.TIME64NS), ("v", DT.INT64))

    def gen():
        for i in range(4):
            yield {"time_": np.full(10, i, dtype=np.int64),
                   "v": np.arange(10, dtype=np.int64) + 10 * i}

    c = Collector()
    c.register(ReplayConnector("g", rel, batches=gen(), rewrite_time=False))
    while c.transfer_once():
        pass
    assert c.store.table("g").stats()["rows_written"] == 40


def test_replay_needs_exactly_one_source():
    rel = Relation.of(("time_", DT.TIME64NS))
    with pytest.raises(InvalidArgument):
        ReplayConnector("x", rel)
    with pytest.raises(InvalidArgument):
        ReplayConnector("x", rel, data={"time_": np.zeros(1, np.int64)}, batches=iter([]))


def test_proc_connectors_real_procfs():
    c = Collector()
    c.register(ProcessStatsConnector())
    c.register(NetworkStatsConnector())
    c.transfer_once()
    ps = c.store.table("process_stats")
    assert ps.stats()["rows_written"] > 0  # at least this test process
    assert os.getpid() in _col(ps, "pid")
    cmds = set()
    for rb, _, _ in ps.cursor():
        cmds.update(ps.dictionaries["cmd"].decode(rb.columns["cmd"][: rb.num_valid]))
    assert any("py" in c_ for c_ in cmds)


def test_collector_refuses_duplicates_and_empty_connectors():
    class Empty(SourceConnector):
        name = "empty"

        def tables(self):
            return []

    c = Collector()
    with pytest.raises(InvalidArgument):
        c.register(Empty())
    c.register(SeqGenConnector(total_rows=10))
    with pytest.raises(InvalidArgument):
        c.register(SeqGenConnector(total_rows=10))


def test_frequency_manager_schedules_from_the_intended_time():
    fm = FrequencyManager()
    fm.register("a", 1.0, now=10.0)
    fm.register("b", 0.5, now=10.0)
    assert sorted(fm.due(10.0)) == ["a", "b"]
    fm.mark_ran("a", 10.2)
    assert fm.due(10.9) == ["b"] and fm.next_due() == 10.0
    fm.mark_ran("b", 13.0)  # fell behind: one period from now, no backlog
    assert fm.next_due() == 11.0
    fm.unregister("a")
    assert fm.next_due() == 13.5


def test_streaming_ingest_while_queries_run():
    """A background poll thread ingests continuously while queries run
    concurrently, each on a consistent snapshot: counts equal sums (v = 1)
    and never decrease."""
    rel = Relation.of(("time_", DT.TIME64NS), ("k", DT.STRING), ("v", DT.INT64))
    n_total = 200_000

    def gen():
        rng = np.random.default_rng(0)
        for i in range(0, n_total, 5000):
            yield {"time_": np.arange(i, i + 5000, dtype=np.int64),
                   "k": rng.choice(["a", "b"], 5000),
                   "v": np.ones(5000, dtype=np.int64)}

    c = Collector()
    c.register(ReplayConnector("stream", rel, batches=gen(), sample_period_s=0.003,
                               rewrite_time=False))
    src = """
import px
df = px.DataFrame(table='stream')
df = df.groupby('k').agg(cnt=('v', px.count), s=('v', px.sum))
px.display(df, 'output')
"""
    q = compile_pxl(src, c.store.schemas(), now=1)
    c.transfer_once()
    execute_plan(q.plan, c.store, device="cpu")
    c.start()
    last_total, saw_partial = 0, False
    try:
        for _ in range(40):
            out = execute_plan(q.plan, c.store, device="cpu")["output"].to_pandas()
            total = int(out.cnt.sum()) if len(out) else 0
            assert total == (int(out.s.sum()) if len(out) else 0)
            assert total >= last_total
            saw_partial |= 0 < total < n_total
            last_total = total
            if total >= n_total:
                break
            time.sleep(0.02)
        assert c.wait_exhausted(30.0)
    finally:
        c.stop()
    out = execute_plan(q.plan, c.store, device="cpu")["output"].to_pandas()
    assert int(out.cnt.sum()) == n_total
    assert saw_partial, "queries never overlapped ingest"


# ------------------------------------------------ tests/test_access_log.py's cases
LINES = [
    '10.0.0.1 - - [30/Jul/2026:10:00:00 +0000] "GET /api/v1/items HTTP/1.1" 200 512 "-" "curl/8" 0.012',
    '10.0.0.2 - - [30/Jul/2026:10:00:01 +0000] "POST /api/v1/cart HTTP/1.1" 500 99 "-" "Mozilla" 0.250',
    '10.0.0.1 - - [30/Jul/2026:10:00:02 +0000] "GET /healthz HTTP/2.0" 200 -',
    "garbage line that does not parse",
]


def test_parse_line_fields():
    from pixie_tpu.collect.access_log import parse_line as ref_parse

    r = parse_line(LINES[0])
    assert r["remote_addr"] == "10.0.0.1"
    assert r["req_method"] == "GET" and r["req_path"] == "/api/v1/items"
    assert r["resp_status"] == 200 and r["resp_body_size"] == 512
    assert r["latency"] == 12_000_000 and r["major_version"] == 1
    r2 = parse_line(LINES[2])
    assert r2["resp_body_size"] == 0 and r2["major_version"] == 2
    assert parse_line(LINES[3]) is None
    assert [parse_line(x) for x in LINES] == [ref_parse(x) for x in LINES]


def test_rotation_truncation_and_missing_path(tmp_path):
    log = tmp_path / "rot.log"
    log.write_text(LINES[0] + "\n")
    conn = AccessLogConnector(str(log), follow=True)
    assert len(conn.transfer_data()["http_events"]["time_"]) == 1
    log.write_text('1.2.3.4 - - [30/Jul/2026:10:00:03 +0000] "GET /x HTTP/1.1" 500 7\n')
    out = conn.transfer_data()  # in-place truncation to shorter content
    assert len(out["http_events"]["time_"]) == 1 and out["http_events"]["resp_status"][0] == 500
    log.rename(tmp_path / "rot.log.1")  # logrotate: a fresh file, a new inode
    log.write_text(LINES[0] + "\n" + LINES[1] + "\n")
    assert len(conn.transfer_data()["http_events"]["time_"]) == 2
    conn2 = AccessLogConnector(str(tmp_path / "nope.log"), follow=True)
    assert conn2.transfer_data() == {}
    assert conn2.read_errors == 1 and not conn2.exhausted
    conn3 = AccessLogConnector(str(tmp_path / "nope2.log"), follow=False)
    assert conn3.transfer_data() == {} and conn3.exhausted


def test_two_logs_register_under_unique_names(tmp_path):
    a, b = tmp_path / "a.log", tmp_path / "b.log"
    a.write_text(LINES[0] + "\n")
    b.write_text(LINES[1] + "\n")
    c = Collector()
    c.register(AccessLogConnector(str(a)))
    c.register(AccessLogConnector(str(b)))
    c.transfer_once()
    assert c.store.table("http_events").stats()["rows_written"] == 2
    c.stop()


def test_tail_parse_query(tmp_path):
    log = tmp_path / "access.log"
    log.write_text("\n".join(LINES[:2]) + "\n")
    collector = Collector()
    conn = AccessLogConnector(str(log), sample_period_s=0.05)
    collector.register(conn)
    collector.transfer_once()
    assert conn.lines_parsed == 2
    with log.open("a") as f:  # a partial line completes later
        f.write(LINES[2] + "\n" + LINES[3] + "\n10.0.0.9 - - [30/Jul/2026")
    collector.transfer_once()
    assert conn.lines_parsed == 3 and conn.lines_dropped == 1
    with log.open("a") as f:
        f.write(':10:00:05 +0000] "GET /late HTTP/1.1" 200 1\n')
    collector.transfer_once()
    assert conn.lines_parsed == 4
    collector.stop()
    q = compile_pxl(
        "import px\n"
        "df = px.DataFrame(table='http_events')\n"
        "df = df.groupby('resp_status').agg(cnt=('latency', px.count))\n"
        "px.display(df, 'o')\n",
        collector.store.schemas(),
    )
    res = execute_plan(q.plan, collector.store, device="cpu")["o"]
    assert {r["resp_status"]: r["cnt"] for r in res.to_records()} == {200: 3, 500: 1}


# ------------------------------------------------------- parity with the reference
def _rel(rel) -> list:
    return [(c.name, c.data_type.name, c.semantic_type.name) for c in rel]


@pytest.mark.parametrize("table", sorted(ref_all_schemas()))
def test_all_schemas_equal_the_references(table):
    got = all_schemas()
    assert sorted(got) == sorted(ref_all_schemas())
    assert _rel(got[table]) == _rel(ref_all_schemas()[table])


def test_http_events_has_the_canonical_18_columns():
    rel = SCHEMAS["http_events"]
    assert len(list(rel)) == 19  # time_ plus 18
    assert rel.col("latency").data_type == DT.INT64
    assert rel.col("upid").data_type == DT.UINT128


def _drain(c):
    while c.transfer_once():
        pass


def test_seq_gen_writes_the_references_rows():
    mine, ref = Collector(), RefCollector()
    mine.register(SeqGenConnector(rows_per_transfer=97, total_rows=1000))
    ref.register(RefSeqGen(rows_per_transfer=97, total_rows=1000))
    _drain(mine)
    _drain(ref)
    for table, cols in (("seq0", ("x", "xmod10", "xsquared")), ("seq1", ("fib",))):
        a, b = mine.store.table(table), ref.store.table(table)
        for col in cols:
            np.testing.assert_array_equal(_col(a, col), _col(b, col))
        assert (np.diff(_col(a, "time_")) >= 0).all()


@pytest.mark.parametrize("rewrite_time", [False, True])
def test_replay_writes_the_references_rows(rewrite_time):
    """The same seeded http_events-like rows, replayed in 3,000-row chunks
    into both packages: every column equal (time_ with its intra-chunk
    offsets when rewritten)."""
    n = 10_000

    def data():
        rng = np.random.default_rng(31)
        return {"time_": np.sort(rng.integers(0, 10**9, n)),
                "service": [f"svc-{i}" for i in rng.integers(0, 16, n)],
                "latency": rng.exponential(50.0, n),
                "status": rng.choice(np.array([200, 404, 500]), n)}

    rel = Relation.of(("time_", DT.TIME64NS), ("service", DT.STRING),
                      ("latency", DT.FLOAT64), ("status", DT.INT64))
    ref_rel = RRel.of(("time_", RDT.TIME64NS), ("service", RDT.STRING),
                      ("latency", RDT.FLOAT64), ("status", RDT.INT64))
    mine, ref = Collector(), RefCollector()
    mine.register(ReplayConnector("r", rel, data=data(), rows_per_transfer=3000,
                                  rewrite_time=rewrite_time))
    ref.register(RefReplay("r", ref_rel, data=data(), rows_per_transfer=3000,
                           rewrite_time=rewrite_time))
    _drain(mine)
    _drain(ref)
    a, b = mine.store.table("r"), ref.store.table("r")
    assert a.stats()["rows_written"] == b.stats()["rows_written"] == n
    for col in ("latency", "status"):
        np.testing.assert_array_equal(_col(a, col), _col(b, col))
    assert (a.dictionaries["service"].decode(_col(a, "service"))
            == b.dictionaries["service"].decode(_col(b, "service")))
    ta, tb = _col(a, "time_"), _col(b, "time_")
    if rewrite_time:
        starts = np.arange(0, n, 3000)
        np.testing.assert_array_equal(ta - np.repeat(ta[starts], np.diff(np.r_[starts, n])),
                                      tb - np.repeat(tb[starts], np.diff(np.r_[starts, n])))
    else:
        np.testing.assert_array_equal(ta, tb)


def test_table_spec_defaults():
    spec = TableSpec("t", Relation.of(("time_", DT.TIME64NS)))
    assert (spec.sample_period_s, spec.batch_rows) == (1.0, 1 << 16)


@pytest.mark.parametrize("form", ["list", "object_array"])
def test_upid_objects_encode_as_the_reference(form):
    """A UINT128 column of UInt128 objects (as a list, as the connectors push
    it, or as an object array) gets the reference's codes and dictionary,
    though the port uniques the (high, low) words and the reference the
    objects."""
    from pixie_tpu.table import TableStore as RefStore
    from pixie_tpu.types import UInt128 as RU
    from pixie_tpu_torch.table import TableStore
    from pixie_tpu_torch.types import UInt128

    rng = np.random.default_rng(5)
    pool = [(int(h), int(lo)) for h, lo in zip(rng.integers(0, 2**40, 300),
                                               rng.integers(0, 2**63, 300))]
    pool[7] = (2**64 - 1, 2**64 - 2)  # words past int64
    idx = rng.integers(0, 300, 5000)
    rel = Relation.of(("time_", DT.TIME64NS), ("upid", DT.UINT128))
    ref_rel = RRel.of(("time_", RDT.TIME64NS), ("upid", RDT.UINT128))
    a, r = TableStore(), RefStore()
    a.create("t", rel)
    r.create("t", ref_rel)
    t = np.arange(5000, dtype=np.int64)
    for part in (slice(0, 2000), slice(2000, 5000)):  # a second write extends it
        upids = [UInt128(*pool[i]) for i in idx[part]]
        if form == "object_array":
            arr = np.empty(len(upids), dtype=object)
            arr[:] = upids
            upids = arr
        a.table("t").write({"time_": t[part], "upid": upids})
        r.table("t").write({"time_": t[part], "upid": [RU(*pool[i]) for i in idx[part]]})
    np.testing.assert_array_equal(_col(a.table("t"), "upid"), _col(r.table("t"), "upid"))
    da, dr = a.table("t").dictionaries["upid"], r.table("t").dictionaries["upid"]
    assert [(v.high, v.low) for v in da.decode(np.arange(da.size))] == [
        (v.high, v.low) for v in dr.decode(np.arange(dr.size))]


def test_upids_whose_word_mix_collides_stay_apart():
    """Two UPIDs whose 64-bit mix of (high, low) is equal still get two
    codes: the encode redoes the batch on the exact word pair; the codes
    equal the reference's."""
    from pixie_tpu.table.dictionary import Dictionary as RefDictionary
    from pixie_tpu.types import UInt128 as RU
    from pixie_tpu_torch.table.dictionary import Dictionary
    from pixie_tpu_torch.types import UInt128

    k = 0x9E3779B97F4A7C15
    pairs = [(0, 5), (1, 5 ^ k), (0, 5), (0, 7), (1, 5 ^ k)]
    d = Dictionary()
    np.testing.assert_array_equal(d.encode([UInt128(*p) for p in pairs]), [0, 1, 0, 2, 1])
    np.testing.assert_array_equal(RefDictionary().encode([RU(*p) for p in pairs]),
                                  [0, 1, 0, 2, 1])
    assert [(v.high, v.low) for v in d.decode(np.arange(d.size))] == [(0, 5), (1, 5 ^ k),
                                                                        (0, 7)]
