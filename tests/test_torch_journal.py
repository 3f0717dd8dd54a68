"""The ingest journal and the wire's json / host_batch frames:
pixie_tpu_torch.table.journal and services.wire against the reference's.

The same writes (numpy seeds; dictionary-encoded STRING and UINT128 columns
among them) journal through both packages into segment files that are
byte-equal, record for record.  A segment written by either package replays
into a fresh store of the other with sealed batches, dictionary codes and
row ids bit-identical to the live table's, and a query over the replayed
store answers as over the live one.  Replay is idempotent by watermark
(re-attach is a no-op; a pre-populated head is skipped), a torn tail is
truncated to the last whole record, a mid-file hole stops replay, and the
PL_JOURNAL_MAX_MB budget prunes the oldest segments, after which replay
keeps the surviving rows' absolute ids.  The json and host_batch frames
encode byte for byte as the reference's, with and without compression
(lz4 falls back to zlib where the module is absent, as the reference's
does), and decode across packages.
"""
from __future__ import annotations

import os

import numpy as np
import pytest

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
from pixie_tpu import flags as ref_flags
from pixie_tpu.compiler import compile_pxl as ref_compile
from pixie_tpu.engine import execute_plan as ref_execute
from pixie_tpu.engine.executor import HostBatch as RefHostBatch
from pixie_tpu.services import wire as ref_wire
from pixie_tpu.table import Dictionary as RefDictionary
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.table import journal as ref_journal
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation, UInt128 as RefU128

from pixie_tpu_torch import flags as port_flags
from pixie_tpu_torch.compiler import compile_pxl
from pixie_tpu_torch.engine import execute_plan
from pixie_tpu_torch.engine.executor import HostBatch
from pixie_tpu_torch.services import wire
from pixie_tpu_torch.table import Dictionary, TableStore
from pixie_tpu_torch.table import journal
from pixie_tpu_torch.types import DataType as DT, Relation, UInt128

JOURNAL_FLAGS = ("PL_DATA_DIR", "PL_JOURNAL_FSYNC", "PL_JOURNAL_SEG_MB", "PL_JOURNAL_MAX_MB",
                 "PL_WIRE_COMPRESS")


@pytest.fixture(autouse=True)
def _journal_flags():
    saved = [(f, n, f.get(n)) for f in (ref_flags, port_flags) for n in JOURNAL_FLAGS]
    yield
    for f, n, v in saved:
        f.set_for_testing(n, v)


def _set(name, value):
    for f in (ref_flags, port_flags):
        f.set_for_testing(name, value)


class Pkg:
    def __init__(self, name):
        self.name = name
        port = name == "port"
        self.DT = DT if port else RefDT
        self.U128 = UInt128 if port else RefU128
        self.Relation = Relation if port else RefRelation
        self.Store = TableStore if port else RefStore
        self.journal = journal if port else ref_journal

    def rel(self):
        D = self.DT
        return self.Relation.of(("time_", D.TIME64NS), ("service", D.STRING),
                                ("upid", D.UINT128), ("latency", D.FLOAT64),
                                ("status", D.INT64), ("ok", D.BOOLEAN))

    def store(self, batch_rows=512):
        ts = self.Store()
        ts.create("http_events", self.rel(), batch_rows=batch_rows)
        return ts

    def query(self, ts):
        src = ("df = px.DataFrame(table='http_events')\n"
               "df = df.groupby(['service', 'status']).agg(n=('latency', px.count),\n"
               "    s=('latency', px.sum), hi=('time_', px.max))\npx.display(df, 'out')\n")
        if self.name == "port":
            res = execute_plan(compile_pxl(src, ts.schemas()).plan, ts, device="cpu")
        else:
            res = ref_execute(ref_compile(src, ts.schemas()).plan, ts)
        return res["out"].to_pandas().sort_values(["service", "status"]).reset_index(drop=True)


REF, PORT = Pkg("ref"), Pkg("port")


def _writes(pkg, seed, sizes, t0=0):
    rng = np.random.default_rng(seed)
    out, t = [], t0
    for n in sizes:
        out.append({
            "time_": np.arange(t, t + n, dtype=np.int64) * 1000,
            "service": rng.choice(["cart", "frontend", "checkout", "pay"], n).tolist(),
            "upid": [pkg.U128(int(a), int(b)) for a, b in rng.integers(0, 4, (n, 2))],
            "latency": rng.exponential(5.0, n),
            "status": rng.choice([200, 404, 500], n),
            "ok": rng.random(n) < 0.9,
        })
        t += n
    return out


SIZES = [700, 1, 0, 1300, 512, 333]


def _journaled(pkg, base, seed=1, sizes=SIZES):
    ts = pkg.store()
    stats = pkg.journal.attach_store(ts, os.path.join(base, "pem0"))
    for w in _writes(pkg, seed, sizes):
        ts.table("http_events").write(w)
    pkg.journal.detach_store(ts)
    return ts, stats


def _segments(base):
    d = os.path.join(base, "pem0", "journal", "http_events")
    return sorted(os.path.join(d, n) for n in os.listdir(d) if n.endswith(".jrn"))


def _table_state(t):
    """Sealed batches, hot rows, dictionaries and watermarks of a table."""
    with t._lock:
        sealed = [(sb.row_id_start, {k: np.asarray(v[:sb.batch.num_valid]).tobytes()
                                     for k, v in sb.batch.columns.items()})
                  for sb in t._sealed]
        hot = t._hot_rows
    return (sealed, hot, {k: [str(v) for v in d.values()] for k, d in t.dictionaries.items()},
            t._total_rows_written, t._next_row_id)


@pytest.mark.parametrize("policy", ["always", "batch", "off"])
def test_segments_are_byte_equal_across_packages(tmp_path, policy):
    _set("PL_JOURNAL_FSYNC", policy)
    _journaled(REF, str(tmp_path / "ref"))
    _journaled(PORT, str(tmp_path / "port"))
    ref_segs, port_segs = _segments(str(tmp_path / "ref")), _segments(str(tmp_path / "port"))
    assert [os.path.basename(p) for p in port_segs] == [os.path.basename(p) for p in ref_segs]
    for a, b in zip(port_segs, ref_segs):
        assert open(a, "rb").read() == open(b, "rb").read()
    payloads, valid, clean = journal.scan_segment(port_segs[0])
    assert clean and len(payloads) == sum(1 for n in SIZES if n)
    metas = [journal.decode_write_record(p)[0] for p in payloads]
    assert [m["wm"] for m in metas] == list(np.cumsum([0] + [n for n in SIZES if n])[:-1])


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref"), ("port", "port")])
def test_a_segment_replays_across_packages_bit_identically(tmp_path, writer, reader):
    src, dst = (REF, PORT) if writer == "ref" else (PORT, REF)
    if writer == reader:
        dst = PORT
    live, _ = _journaled(src, str(tmp_path))
    fresh = dst.Store()  # tables come back from the journal's schema.json
    stats = dst.journal.attach_store(fresh, os.path.join(str(tmp_path), "pem0"))
    dst.journal.detach_store(fresh)
    assert stats["rows"] == sum(SIZES) and stats["tables"] == 1
    assert _table_state(fresh.table("http_events")) == _table_state(live.table("http_events"))
    got, want = dst.query(fresh), src.query(live)
    assert got["n"].tolist() == want["n"].tolist()
    assert got["hi"].tolist() == want["hi"].tolist()
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-12)


def test_replay_is_idempotent_by_watermark(tmp_path):
    base = str(tmp_path)
    live, _ = _journaled(PORT, base)
    ts = PORT.store()
    # a pre-populated head: the first two writes are already in the store
    for w in _writes(PORT, 1, SIZES)[:2]:
        ts.table("http_events").write(w)
    stats = journal.attach_store(ts, os.path.join(base, "pem0"))
    assert stats["rows"] == sum(SIZES) - 701
    journal.detach_store(ts)
    again = journal.attach_store(ts, os.path.join(base, "pem0"))  # re-attach: no-op
    journal.detach_store(ts)
    assert again["rows"] == 0 and again["applied"] == 0
    assert _table_state(ts.table("http_events")) == _table_state(live.table("http_events"))


def test_torn_tail_truncates_in_both_packages(tmp_path):
    out = {}
    for pkg in (REF, PORT):
        base = str(tmp_path / pkg.name)
        _journaled(pkg, base)
        seg = _segments(base)[-1]
        whole = os.path.getsize(seg)
        with open(seg, "ab") as f:
            f.write(b"PXJ1\x10\x00\x00\x00garbage")  # a record torn mid-write
        j = pkg.journal.TableJournal(os.path.dirname(seg))
        dropped = j.recover()
        assert os.path.getsize(seg) == whole
        out[pkg.name] = (dropped, whole, len(j.replay()))
    assert out["port"] == out["ref"]
    assert out["port"][0] == 4 + 4 + 7


def test_a_mid_file_hole_stops_replay(tmp_path):
    """A corrupt record in an older (rotated) segment: replay stops at the
    hole rather than apply rows past it, as the reference's does."""
    _set("PL_JOURNAL_SEG_MB", 1)
    big = [40_000] * 4
    out = {}
    for pkg in (REF, PORT):
        base = str(tmp_path / pkg.name)
        _journaled(pkg, base, sizes=big)
        segs = _segments(base)
        assert len(segs) >= 2
        raw = bytearray(open(segs[0], "rb").read())
        raw[len(raw) // 2] ^= 0xFF  # flip a byte inside the first segment
        open(segs[0], "wb").write(bytes(raw))
        fresh = pkg.Store()
        stats = pkg.journal.attach_store(fresh, os.path.join(base, "pem0"))
        pkg.journal.detach_store(fresh)
        out[pkg.name] = (stats["rows"], fresh.table("http_events")._total_rows_written)
    assert out["port"] == out["ref"]
    assert out["port"][0] < sum(big)


def test_journal_budget_prunes_and_replay_keeps_absolute_row_ids(tmp_path):
    _set("PL_JOURNAL_SEG_MB", 1)
    _set("PL_JOURNAL_MAX_MB", 2)
    big = [30_000] * 8
    out = {}
    for pkg in (REF, PORT):
        base = str(tmp_path / pkg.name)
        live, _ = _journaled(pkg, base, sizes=big)
        segs = _segments(base)
        fresh = pkg.Store()
        stats = pkg.journal.attach_store(fresh, os.path.join(base, "pem0"))
        pkg.journal.detach_store(fresh)
        t = fresh.table("http_events")
        out[pkg.name] = ([os.path.basename(s) for s in segs], stats["rows"],
                         t.first_row_id(), t.last_row_id(), t._total_rows_written)
    assert out["port"] == out["ref"]
    names, rows, first, last, total = out["port"]
    assert names[0] != "seg-00000001.jrn"  # the head was pruned
    assert rows < sum(big) and total == sum(big) and first > 0


def test_node_dir_and_non_durable_tables():
    _set("PL_DATA_DIR", "")
    assert journal.node_dir("pem0") is None
    _set("PL_DATA_DIR", "/data")
    assert journal.node_dir("pem0") == ref_journal.node_dir("pem0") == "/data/pem0"
    assert journal.non_durable_tables() == ref_journal.non_durable_tables()


# ------------------------------------------------------------ wire frames


def _host_batch(pkg_name, seed, n=257):
    port = pkg_name == "port"
    D, U, Dct, HB = ((DT, UInt128, Dictionary, HostBatch) if port
                     else (RefDT, RefU128, RefDictionary, RefHostBatch))
    rng = np.random.default_rng(seed)
    ds, du = Dct(), Dct()
    cols = {
        "service": ds.encode(rng.choice(["cart", "frontend", "", "ünïcode"], n).tolist()),
        "upid": du.encode([U(int(a), int(b)) for a, b in rng.integers(0, 3, (n, 2))]),
        "time_": np.arange(n, dtype=np.int64) * 7,
        "latency": rng.exponential(5.0, n),
        "ok": rng.random(n) < 0.5,
        "code": rng.integers(-5, 5, n).astype(np.int64),
    }
    dtypes = {"service": D.STRING, "upid": D.UINT128, "time_": D.TIME64NS,
              "latency": D.FLOAT64, "ok": D.BOOLEAN, "code": D.INT64}
    return HB(dtypes, {"service": ds, "upid": du}, cols)


def _same_hb(a, b):
    assert list(a.cols) == list(b.cols)
    assert {k: v.name for k, v in a.dtypes.items()} == {k: v.name for k, v in b.dtypes.items()}
    for k in a.cols:
        assert np.asarray(a.cols[k]).tobytes() == np.asarray(b.cols[k]).tobytes(), k
        assert np.asarray(a.cols[k]).dtype == np.asarray(b.cols[k]).dtype, k
    assert {k: [str(v) for v in d.values()] for k, d in a.dicts.items()} == \
        {k: [str(v) for v in d.values()] for k, d in b.dicts.items()}


@pytest.mark.parametrize("compress", ["", "zlib:0", "lz4:0", "zlib:100000000"])
@pytest.mark.parametrize("meta", [None, {"t": "x", "wm": 5, "n": 257}])
def test_host_batch_frames_are_byte_equal_and_decode_across(compress, meta):
    _set("PL_WIRE_COMPRESS", compress)
    port_hb, ref_hb = _host_batch("port", 3), _host_batch("ref", 3)
    pf, rf = wire.encode_host_batch(port_hb, meta), ref_wire.encode_host_batch(ref_hb, meta)
    assert pf == rf
    kind, back = wire.decode_frame(rf)
    assert kind == "host_batch" and isinstance(back, HostBatch)
    _same_hb(back, port_hb)
    kind, back = ref_wire.decode_frame(pf)
    _same_hb(back, ref_hb)
    if meta:
        assert {k: back.wire_meta[k] for k in meta} == meta


@pytest.mark.parametrize("compress", ["", "zlib:0", "lz4:0"])
def test_json_frames_are_byte_equal(compress):
    _set("PL_WIRE_COMPRESS", compress)
    meta = {"msg": "execute", "plan": {"ops": [1, 2, {"x": None}]}, "f": 1.5}
    assert wire.encode_json(meta) == ref_wire.encode_json(meta)
    assert wire.decode_frame(ref_wire.encode_json(meta)) == ("json", meta)


def test_write_records_are_byte_equal():
    for seed in range(3):
        wp, wr = _writes(PORT, seed, [100])[0], _writes(REF, seed, [100])[0]
        a = journal.encode_write_record("http_events", PORT.rel(), wp, 1000, 100)
        b = ref_journal.encode_write_record("http_events", REF.rel(), wr, 1000, 100)
        assert a == b
        assert journal.pack_record(a) == ref_journal.pack_record(b)
        meta, cols = journal.decode_write_record(b)
        assert meta == {"t": "http_events", "wm": 1000, "n": 100} | {
            k: v for k, v in meta.items() if k not in ("t", "wm", "n")}
        assert list(cols["service"]) == wp["service"]
        assert cols["upid"] == wp["upid"]
