"""The compressed on-disk cold tier: pixie_tpu_torch.table.lifecycle against
pixie_tpu.table.lifecycle.

The cold-tier cases of tests/test_lifecycle.py that need no broker run
through both packages over the same writes (numpy seeds): demotion by the
RAM ceiling and by age, demote-then-expire under the disk budget (a
snapshot taken before the expiry still serves), heat-driven promotion
behind the headroom gate, restore before journal replay (idempotent, a
lost middle segment or a torn file refilled by the journal), and the
journal's budget counting cold bytes.  Each case's outcome — the table's
content fingerprint (dictionary codes decoded), the tier's counters and the
cold files' bytes — equals the reference's.  The cold files are byte-equal
across packages, and each package restores the other's.

Then the executor: a query over a half-cold table equals the all-RAM
table's answer bit for bit in both packages; its cold feeds are counted as
the `cold` heat tier with the reference's cells, are uploaded fresh every
scan (counted in h2d_bytes) and never enter the resident tier or the feed
cache; and after PL_COLD_PROMOTE_READS scans the cold batches are back in
RAM.
"""
from __future__ import annotations

import os
import time

import numpy as np
import pytest

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
import pixie_tpu.matview  # noqa: F401
import pixie_tpu.trace  # noqa: F401
from pixie_tpu import flags as ref_flags
from pixie_tpu.compiler import compile_pxl as ref_compile
from pixie_tpu.engine import execute_plan as ref_execute
from pixie_tpu.engine import resident as ref_resident
from pixie_tpu.engine.executor import clear_device_cache as ref_clear_cache
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.table import heat as ref_heat
from pixie_tpu.table import journal as ref_journal
from pixie_tpu.table import lifecycle as ref_lifecycle
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation

import pixie_tpu_torch.engine.executor as port_executor
import pixie_tpu_torch.matview  # noqa: F401
from pixie_tpu_torch import flags as port_flags
from pixie_tpu_torch.compiler import compile_pxl
from pixie_tpu_torch.engine import execute_plan
from pixie_tpu_torch.engine import resident as port_resident
from pixie_tpu_torch.table import TableStore
from pixie_tpu_torch.table import heat, journal, lifecycle
from pixie_tpu_torch.types import DataType as DT, Relation

COLD_FLAGS = ("PL_COLD_TIER", "PL_COLD_AFTER_S", "PL_COLD_MAX_HOT_MB", "PL_COLD_MAX_DISK_MB",
              "PL_COLD_PROMOTE_READS", "PL_DATA_DIR", "PL_JOURNAL_FSYNC",
              "PL_MATVIEW_ENABLED", "PL_TRACING_ENABLED", "PX_CPU_CROSSOVER_ROWS",
              "PL_WIRE_COMPRESS")

AGG_SCRIPT = """
df = px.DataFrame(table='http_events')
df = df.groupby('service').agg(cnt=('latency', px.count), mx=('latency', px.max),
                               s=('status', px.sum))
px.display(df, 'out')
"""


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = [(f, n, f.get(n)) for f in (ref_flags, port_flags) for n in COLD_FLAGS]
    for f in (ref_flags, port_flags):
        f.set_for_testing("PL_JOURNAL_FSYNC", "off")
        f.set_for_testing("PL_MATVIEW_ENABLED", False)
        f.set_for_testing("PL_TRACING_ENABLED", True)
        f.set_for_testing("PX_CPU_CROSSOVER_ROWS", 0)
    for clear in (ref_resident.clear_for_testing, port_resident.clear_for_testing,
                  ref_clear_cache, port_executor.clear_device_cache,
                  ref_heat.reset_for_testing, heat.reset_for_testing):
        clear()
    yield
    for f, n, v in saved:
        f.set_for_testing(n, v)


class Pkg:
    def __init__(self, name):
        self.name = name
        port = name == "port"
        self.flags = port_flags if port else ref_flags
        self.journal = journal if port else ref_journal
        self.lifecycle = lifecycle if port else ref_lifecycle
        self.heat = heat if port else ref_heat
        self.DT = DT if port else RefDT
        self.Relation = Relation if port else RefRelation
        self.Store = TableStore if port else RefStore

    def set(self, **kw):
        for k, v in kw.items():
            self.flags.set_for_testing(k, v)

    def store(self, batch_rows=512):
        D = self.DT
        ts = self.Store()
        ts.create("http_events", self.Relation.of(
            ("time_", D.TIME64NS), ("service", D.STRING), ("latency", D.FLOAT64),
            ("status", D.INT64)), batch_rows=batch_rows, max_bytes=1 << 32)
        return ts

    def query(self, ts):
        if self.name == "port":
            res = execute_plan(compile_pxl(AGG_SCRIPT, ts.schemas()).plan, ts, device="cpu")
        else:
            res = ref_execute(ref_compile(AGG_SCRIPT, ts.schemas()).plan, ts)
        return res["out"]


PKGS = [Pkg("ref"), Pkg("port")]


def _mkdata(seed, n):
    rng = np.random.default_rng(seed)
    return {
        "time_": np.arange(n, dtype=np.int64) * 1000,
        "service": rng.choice(["cart", "auth", "web"], n).tolist(),
        "latency": rng.integers(0, 1000, n).astype(np.float64),
        "status": rng.choice([200, 500], n),
    }


def _table_bytes(ts):
    """Content fingerprint, decoding cold batches along the way (dictionary
    codes decoded — code spaces must survive round trips)."""
    t = ts.table("http_events")
    out = []
    for rb, _rid, _gen in t.cursor():
        for c in sorted(rb.columns):
            arr = rb.columns[c][:rb.num_valid]
            if c in t.dictionaries:
                out.append("\x00".join(str(v) for v in t.dictionaries[c].decode(arr)).encode())
            else:
                out.append(arr.tobytes())
    return b"\x01".join(out)


def _cold_files(base):
    d = os.path.join(base, "cold", "http_events")
    if not os.path.isdir(d):
        return {}
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


def both(tmp_path, case):
    """Run `case(pkg, base)` for both packages, each under its own data
    directory; outcomes and cold files must be equal across packages."""
    out = {}
    for pk in PKGS:
        base = str(tmp_path / pk.name)
        os.makedirs(base, exist_ok=True)
        out[pk.name] = (case(pk, base), _cold_files(base))
    assert out["port"][0] == out["ref"][0]
    assert out["port"][1] == out["ref"][1]
    return out["port"][0]


def _demote_all(t):
    n = 0
    with t._lock:
        while t.cold.demote_oldest_locked():
            n += 1
    return n


# ----------------------------------------------------------- demotion


def test_cold_flag_off_is_noop(tmp_path):
    def case(pk, base):
        pk.set(PL_COLD_TIER=0)
        ts = pk.store()
        pk.journal.attach_store(ts, base)
        t = ts.table("http_events")
        t.write(_mkdata(1, 4000))
        pk.journal.detach_store(ts)
        return t.cold is None, os.path.isdir(os.path.join(base, "cold"))

    assert both(tmp_path, case) == (True, False)


def test_cold_ceiling_demotes_and_serves_bit_equal(tmp_path):
    def case(pk, base):
        pk.set(PL_COLD_TIER=0)
        control = pk.store()
        control.table("http_events").write(_mkdata(1, 8000))
        want = _table_bytes(control)
        pk.set(PL_COLD_TIER=1, PL_COLD_AFTER_S=0.0, PL_COLD_MAX_HOT_MB=1)
        ts = pk.store()
        pk.journal.attach_store(ts, base)
        t = ts.table("http_events")
        t.write(_mkdata(1, 8000))
        demoted = _demote_all(t)
        cbytes, csegs = t.cold.disk_usage()
        raw = sum(sb.nbytes for sb in t._sealed if getattr(sb, "is_cold", False))
        same = _table_bytes(ts) == want
        pk.journal.detach_store(ts)
        return demoted, csegs, cbytes < raw, same, t.cold.stats()

    demoted, csegs, smaller, same, _stats = both(tmp_path, case)
    assert demoted == csegs > 0 and smaller and same


def test_cold_age_driven_demotion_in_retention_pass(tmp_path):
    def case(pk, base):
        pk.set(PL_COLD_TIER=1, PL_COLD_AFTER_S=0.05, PL_COLD_MAX_HOT_MB=0)
        ts = pk.store()
        pk.journal.attach_store(ts, base)
        t = ts.table("http_events")
        t.write(_mkdata(1, 2048))
        time.sleep(0.1)
        t.write(_mkdata(2, 512))  # the retention pass ages the first batches out
        pk.journal.detach_store(ts)
        return t.cold.demotions > 0, any(getattr(sb, "is_cold", False) and not sb.in_ram
                                         for sb in t._sealed)

    assert both(tmp_path, case) == (True, True)


def test_ram_ceiling_demotes_on_write(tmp_path):
    """PL_COLD_MAX_HOT_MB: the write's retention pass keeps sealed RAM
    under the ceiling by demoting the oldest batches."""
    def case(pk, base):
        pk.set(PL_COLD_TIER=1, PL_COLD_AFTER_S=0.0, PL_COLD_MAX_HOT_MB=1)
        ts = pk.store(batch_rows=4096)
        pk.journal.attach_store(ts, base)
        t = ts.table("http_events")
        for s in range(4):
            t.write(_mkdata(s, 40_000))
        pk.journal.detach_store(ts)
        return t._sealed_bytes <= 1 << 20, t.cold.stats(), len(t._sealed)

    under, stats, n = both(tmp_path, case)
    assert under and stats["demotions"] > 0 and n == 160_000 // 4096


def test_cold_demote_then_expire_under_disk_budget(tmp_path):
    def case(pk, base):
        pk.set(PL_COLD_TIER=1, PL_COLD_AFTER_S=0.0)
        ts = pk.store()
        pk.journal.attach_store(ts, base)
        t = ts.table("http_events")
        t.write(_mkdata(1, 8000))
        _demote_all(t)
        pre = _table_bytes(ts)
        snap = t.cursor()
        first_gen = t._sealed[0].gen
        with t._lock:  # expire the cold head the way manage_locked does
            sb = t._sealed.pop(0)
            t.cold.on_drop_locked(sb)
            t._expired_batches += 1
            t.cold.expired += 1
        got = []
        for rb, _rid, _gen in snap:
            for c in sorted(rb.columns):
                arr = rb.columns[c][:rb.num_valid]
                if c in t.dictionaries:
                    got.append("\x00".join(str(v) for v in t.dictionaries[c].decode(arr)).encode())
                else:
                    got.append(arr.tobytes())
        pk.journal.detach_store(ts)
        return t._sealed[0].gen != first_gen, b"\x01".join(got) == pre, t.cold.stats()

    moved, snap_ok, _stats = both(tmp_path, case)
    assert moved and snap_ok


def test_cold_promotion_heat_driven_with_headroom_gate(tmp_path):
    def case(pk, base):
        pk.set(PL_COLD_TIER=1, PL_COLD_AFTER_S=0.0, PL_COLD_PROMOTE_READS=2,
               PL_COLD_MAX_HOT_MB=0)
        ts = pk.store()
        pk.journal.attach_store(ts, base)
        t = ts.table("http_events")
        t.write(_mkdata(1, 1024))
        with t._lock:
            assert t.cold.demote_oldest_locked()
        ref = next(sb for sb in t._sealed if getattr(sb, "is_cold", False))
        t.cold.note_reads([ref.gen])
        after_one = ref.in_ram
        t.cold.note_reads([ref.gen])
        after_two = (ref.in_ram, t.cold.promotions, os.path.exists(ref.path))
        with t._lock:
            assert t.cold.demote_oldest_locked()
        ref2 = next(sb for sb in t._sealed if getattr(sb, "is_cold", False) and not sb.in_ram)
        pk.set(PL_COLD_MAX_HOT_MB=1)
        t._sealed_bytes = (1 << 20) + 1  # a full RAM tier
        ref2.reads = 5
        gated = (t.cold.promote(ref2), ref2.reads, ref2.in_ram)
        pk.journal.detach_store(ts)
        return after_one, after_two, gated

    assert both(tmp_path, case) == (False, (True, 1, False), (False, 0, False))


# ------------------------------------------------------------ restore


def test_cold_restore_is_idempotent_and_bit_equal(tmp_path):
    def case(pk, base):
        pk.set(PL_COLD_TIER=1, PL_COLD_AFTER_S=0.0)
        ts = pk.store()
        pk.journal.attach_store(ts, base)
        t = ts.table("http_events")
        t.write(_mkdata(1, 4000))
        n_cold = _demote_all(t)
        want = _table_bytes(ts)
        pk.journal.detach_store(ts)
        ts2 = pk.store()
        stats = pk.journal.attach_store(ts2, base)
        t2 = ts2.table("http_events")
        out = (n_cold, stats["cold_restored"], t2.cold.stats()["cold_segments"],
               sum(rb.num_valid for rb, _r, _g in t2.cursor()), _table_bytes(ts2) == want)
        pk.journal.detach_store(ts2)
        return out

    n_cold, restored, segs, rows, same = both(tmp_path, case)
    assert n_cold == restored == segs > 0 and rows == 4000 and same


def test_each_package_restores_the_others_cold_files(tmp_path):
    for writer, reader in ((PKGS[0], PKGS[1]), (PKGS[1], PKGS[0])):
        base = str(tmp_path / f"{writer.name}_to_{reader.name}")
        writer.set(PL_COLD_TIER=1, PL_COLD_AFTER_S=0.0)
        reader.set(PL_COLD_TIER=1, PL_COLD_AFTER_S=0.0)
        ts = writer.store()
        writer.journal.attach_store(ts, base)
        ts.table("http_events").write(_mkdata(3, 3000))
        n = _demote_all(ts.table("http_events"))
        want = _table_bytes(ts)
        writer.journal.detach_store(ts)
        ts2 = reader.Store()
        stats = reader.journal.attach_store(ts2, base)
        assert stats["cold_restored"] == n > 0
        assert _table_bytes(ts2) == want
        reader.journal.detach_store(ts2)


def test_cold_restore_skips_segments_after_a_gap(tmp_path):
    def case(pk, base):
        pk.set(PL_COLD_TIER=1, PL_COLD_AFTER_S=0.0)
        ts = pk.store()
        pk.journal.attach_store(ts, base)
        ts.table("http_events").write(_mkdata(1, 4000))
        _demote_all(ts.table("http_events"))
        want = _table_bytes(ts)
        pk.journal.detach_store(ts)
        cdir = pk.lifecycle.cold_dir(base, "http_events")
        segs = sorted(os.listdir(cdir))
        os.remove(os.path.join(cdir, segs[1]))  # lose a middle segment
        ts2 = pk.store()
        stats = pk.journal.attach_store(ts2, base)
        out = (stats["cold_restored"], _table_bytes(ts2) == want)
        pk.journal.detach_store(ts2)
        return out

    assert both(tmp_path, case) == (1, True)


def test_cold_torn_segment_discarded_and_journal_covers(tmp_path):
    def case(pk, base):
        pk.set(PL_COLD_TIER=1, PL_COLD_AFTER_S=0.0)
        ts = pk.store()
        pk.journal.attach_store(ts, base)
        ts.table("http_events").write(_mkdata(1, 2000))
        _demote_all(ts.table("http_events"))
        want = _table_bytes(ts)
        pk.journal.detach_store(ts)
        cdir = pk.lifecycle.cold_dir(base, "http_events")
        path = os.path.join(cdir, sorted(os.listdir(cdir))[0])
        raw = open(path, "rb").read()
        open(path, "wb").write(raw[: len(raw) // 2])  # a torn demote
        ts2 = pk.store()
        pk.journal.attach_store(ts2, base)
        out = (os.path.exists(path), _table_bytes(ts2) == want)
        pk.journal.detach_store(ts2)
        return out

    assert both(tmp_path, case) == (False, True)


def test_journal_prune_counts_cold_disk(tmp_path):
    def case(pk, base):
        pk.set(PL_COLD_TIER=1, PL_COLD_AFTER_S=0.0)
        ts = pk.store()
        pk.journal.attach_store(ts, base)
        t = ts.table("http_events")
        t.write(_mkdata(1, 2000))
        with t._lock:
            assert t.cold.demote_oldest_locked()
        out = (t.journal.extra_disk is not None,
               t.journal.extra_disk() == t.cold.disk_usage_bytes() > 0)
        pk.journal.detach_store(ts)
        return out

    assert both(tmp_path, case) == (True, True)


# ------------------------------------------------------------ the executor


def _half_cold(pk, base, n=16_384, batch_rows=1024):
    pk.set(PL_COLD_TIER=1, PL_COLD_AFTER_S=0.0, PL_COLD_MAX_HOT_MB=0,
           PL_COLD_PROMOTE_READS=3)
    ts = pk.store(batch_rows=batch_rows)
    pk.journal.attach_store(ts, base)
    t = ts.table("http_events")
    t.write(_mkdata(7, n))
    with t._lock:
        for _ in range(len(t._sealed) // 2):
            t.cold.demote_oldest_locked()
    return ts, t


def test_half_cold_query_equals_the_all_ram_answer(tmp_path):
    out = {}
    for pk in PKGS:
        pk.set(PL_COLD_TIER=0)
        control = pk.store(batch_rows=1024)
        control.table("http_events").write(_mkdata(7, 16_384))
        want = pk.query(control).to_pandas().sort_values("service").reset_index(drop=True)
        ts, t = _half_cold(pk, str(tmp_path / pk.name))
        got = pk.query(ts).to_pandas().sort_values("service").reset_index(drop=True)
        for c in want.columns:
            g, w = got[c].to_numpy(), want[c].to_numpy()
            if g.dtype == object:
                assert g.tolist() == w.tolist(), (pk.name, c)
            else:
                assert g.tobytes() == w.tobytes(), (pk.name, c)
        out[pk.name] = got
        pk.journal.detach_store(ts)
    for c in out["ref"].columns:
        assert out["port"][c].tolist() == out["ref"][c].tolist()


def test_cold_feeds_heat_tier_uploads_and_promotion(tmp_path):
    """Cold feeds: the `cold` heat tier with the reference's cells; uploaded
    fresh every scan (h2d_bytes), never resident, never in the feed cache;
    promoted back to RAM after PL_COLD_PROMOTE_READS scans."""
    states = {}
    for pk in PKGS:
        ts, t = _half_cold(pk, str(tmp_path / pk.name))
        n_cold = sum(1 for sb in t._sealed if getattr(sb, "is_cold", False) and not sb.in_ram)
        assert n_cold == 8
        stats = []
        for _ in range(3):
            res = pk.query(ts)
            stats.append((res.exec_stats["rows_scanned"], res.exec_stats.get("h2d_bytes", 0)))
        states[pk.name] = (n_cold, t.cold.stats()["promotions"],
                           sum(1 for sb in t._sealed if getattr(sb, "in_ram", True)), stats)
        pk.journal.detach_store(ts)
    assert sorted((r["tier"], r["age_bucket"], r["rows_scanned"], r["bytes"])
                  for r in heat.snapshot_rows()) == \
        sorted((r["tier"], r["age_bucket"], r["rows_scanned"], r["bytes"])
               for r in ref_heat.snapshot_rows())
    tiers = {r["tier"]: r["rows_scanned"] for r in heat.snapshot_rows()}
    assert tiers["cold"] == 3 * 8 * 1024
    n_cold, promotions, in_ram, stats = states["port"]
    assert promotions == 8 and in_ram == 16  # every cold batch promoted after 3 reads
    assert states["ref"][:3] == states["port"][:3]
    # every scan uploads the cold half again: 20 B a row x 8192 rows
    for rows, h2d in stats:
        assert rows == 16_384 and h2d >= 8 * 1024 * 20


def test_cold_batches_never_enter_the_device_caches(tmp_path):
    ts, t = _half_cold(PKGS[1], str(tmp_path))
    cold_gens = {sb.gen for sb in t._sealed if getattr(sb, "is_cold", False)}
    PKGS[1].query(ts)
    for key in list(port_executor._DEVICE_CACHE):
        if key[0] == t.uid:
            assert not (set(key[1]) & cold_gens), key
    for key, entry in list(port_resident._TIER.items()):
        if key[0] == t.uid:
            assert entry.gen_lo > max(cold_gens), (key, entry.gen_lo)
    PKGS[1].journal.detach_store(ts)
