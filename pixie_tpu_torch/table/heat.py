"""Shard heat accounting: the storage-side twin of the query flight recorder.

The flight recorder (pixie_tpu_torch.observe) explains every *query*; this module
explains the *data plane* the queries run over.  Every executor feed bumps a
per-(table, shard, serving tier, batch-age bucket) cell — rows scanned,
bytes moved, an exponentially time-decayed heat score, last access — so
"which shards are hot and from which tier are they served" is a measured
answer, not a guess.  The PL_SELF_METRICS_S cron folds the model into
``self_telemetry.shard_heat`` (decayed heat per shard + per-table skew
factor) and ``self_telemetry.storage_state`` (what each agent actually
holds: hot rows, sealed batches with an age histogram, journal disk usage,
resident-tier and matview state bytes, replication lag per peer).

Design constraints, in order:

  * **Hot-path cost ~zero.**  Bumps are lock-free: cell creation uses
    ``dict.setdefault`` (atomic under the GIL) and the counter adds are
    plain attribute ops — no lock, no allocation after warm-up.  One bump
    covers a whole coalesced feed part, never a row.  A rare lost update
    under thread races costs a sliver of telemetry, not correctness.
  * **Flag-off bit-identical.**  The executor only calls in here when
    ``observe.enabled()`` (the PL_TRACING_ENABLED master switch); with
    tracing off the model is never touched and query results are
    bit-identical to the uninstrumented path.
  * **Deterministic math.**  Every entry point takes an explicit
    ``now_ns`` so tests can replay exact decay trajectories.  Decay is
    ``heat *= 0.5 ** (dt / half_life)`` applied lazily at bump/read time —
    ratios between shards are preserved, which is what makes the folded
    ``skew`` agree with raw per-shard row counts.
  * **Bounded label space.**  Table and shard idents run through
    ``metrics.capped_label`` so a tracepoint-churning workload cannot grow
    the model (or the gauge families derived from it) without bound.

``top_shards()`` is the API the shard rebalancer (services/rebalance.py,
not ported yet) consumes: the hottest (table, shard) pairs by decayed heat, the
measured input that replaces placement-by-constant.

Copied from the reference package (pixie_tpu/table/heat.py); the port's
`FeedRecorder` bumps a one-bucket feed once (see the class).
"""
from __future__ import annotations

import json
import time
from typing import Optional

from pixie_tpu_torch import flags, metrics

flags.define_float(
    "PL_HEAT_HALF_LIFE_S", 600.0,
    "half-life (seconds) of the shard-heat exponential decay: a shard "
    "untouched for one half-life keeps half its heat score; <=0 disables "
    "decay (heat becomes a plain rows-scanned counter)")

#: batch-age buckets, youngest first.  "hot" is the unsealed write
#: remainder; "sealed" is a sealed batch whose data time is unknown (no
#: time_ column to age by); the rest bound the batch's data age at feed
#: time, so a batch ROLLS OVER to the next bucket as it ages.
AGE_BUCKETS = ("hot", "<1m", "<10m", "<1h", "<1d", "old", "sealed")

_AGE_BOUNDS_S = ((60.0, "<1m"), (600.0, "<10m"), (3600.0, "<1h"),
                 (86400.0, "<1d"))


def age_bucket(age_s: Optional[float]) -> str:
    """Data age (seconds) -> bucket label; None (no time info) -> 'sealed'."""
    if age_s is None:
        return "sealed"
    for bound, label in _AGE_BOUNDS_S:
        if age_s < bound:
            return label
    return "old"


class _Cell:
    """One (table, shard, tier, age-bucket) accumulator.  Mutated without a
    lock (see module docstring); read via a decayed copy."""

    __slots__ = ("rows", "bytes", "heat", "last_ns")

    def __init__(self):
        self.rows = 0
        self.bytes = 0
        self.heat = 0.0
        self.last_ns = 0


def _decay_factor(dt_ns: int) -> float:
    half_life = float(flags.get("PL_HEAT_HALF_LIFE_S"))
    if half_life <= 0 or dt_ns <= 0:
        return 1.0
    return 0.5 ** (dt_ns / 1e9 / half_life)


class HeatModel:
    """The per-process access model: lock-free bumps in, decayed rows out."""

    def __init__(self):
        self._cells: dict[tuple, _Cell] = {}

    # -------------------------------------------------------------- hot path
    def record_feed(self, table: str, shard: str, rows: int, nbytes: int,
                    tier: str = "stream", bucket: str = "hot",
                    now_ns: Optional[int] = None) -> None:
        """One coalesced feed part touched `rows` rows of (table, shard)
        served from `tier` (resident / hbm_cache / stream).  Lazy decay:
        the standing heat decays to `now` before the new rows add in."""
        now_ns = int(now_ns if now_ns is not None else time.time_ns())
        key = (metrics.capped_label("heat_table", str(table)),
               metrics.capped_label("heat_shard", str(shard)),
               str(tier), str(bucket))
        cell = self._cells.get(key)
        if cell is None:
            cell = self._cells.setdefault(key, _Cell())
        cell.heat = cell.heat * _decay_factor(now_ns - cell.last_ns) + rows
        cell.last_ns = now_ns
        cell.rows += int(rows)
        cell.bytes += int(nbytes)

    # ------------------------------------------------------------- read side
    def _decayed_cells(self, now_ns: int) -> list[tuple[tuple, dict]]:
        out = []
        for key, cell in list(self._cells.items()):
            out.append((key, {
                "rows": cell.rows, "bytes": cell.bytes,
                "heat": cell.heat * _decay_factor(now_ns - cell.last_ns),
                "last_ns": cell.last_ns,
            }))
        return out

    def shard_heat(self, now_ns: Optional[int] = None) -> dict:
        """{(table, shard): decayed heat} summed over tiers and buckets."""
        now_ns = int(now_ns if now_ns is not None else time.time_ns())
        agg: dict[tuple, float] = {}
        for (table, shard, _tier, _bucket), c in self._decayed_cells(now_ns):
            agg[(table, shard)] = agg.get((table, shard), 0.0) + c["heat"]
        return agg

    def skew(self, now_ns: Optional[int] = None) -> dict[str, float]:
        """Per-table max/mean decayed shard heat (1.0 = perfectly even) —
        the rebalance signal.  Uniform decay preserves shard ratios, so
        this agrees with raw per-shard row counts."""
        by_table: dict[str, list[float]] = {}
        for (table, _shard), h in self.shard_heat(now_ns).items():
            by_table.setdefault(table, []).append(h)
        out = {}
        for table, heats in by_table.items():
            mean = sum(heats) / max(len(heats), 1)
            out[table] = (max(heats) / mean) if mean > 0 else 1.0
        return out

    def top_shards(self, n: int = 10,
                   now_ns: Optional[int] = None) -> list[tuple]:
        """The hottest (table, shard, decayed_heat) triples — the input the
        shard rebalancer (services/rebalance.py) ranks re-homing candidates by."""
        ranked = sorted(self.shard_heat(now_ns).items(),
                        key=lambda kv: (-kv[1], kv[0]))
        return [(t, s, h) for (t, s), h in ranked[:max(int(n), 0)]]

    def snapshot_rows(self, now_ns: Optional[int] = None) -> list[dict]:
        """The fold: one self_telemetry.shard_heat row per live cell, heat
        decayed to `now`, per-table skew stamped on every row."""
        now_ns = int(now_ns if now_ns is not None else time.time_ns())
        skews = self.skew(now_ns)
        rows = []
        for (table, shard, tier, bucket), c in self._decayed_cells(now_ns):
            rows.append({
                "time_": now_ns,
                "table_name": table,
                "shard": shard,
                "tier": tier,
                "age_bucket": bucket,
                "rows_scanned": c["rows"],
                "bytes": c["bytes"],
                "heat": round(c["heat"], 6),
                "skew": round(skews.get(table, 1.0), 6),
                "last_access": c["last_ns"],
            })
        rows.sort(key=lambda r: (r["table_name"], r["shard"], r["tier"],
                                 r["age_bucket"]))
        return rows

    def reset(self) -> None:
        self._cells = {}


#: the process-wide model (executors bump it, the self-metrics cron folds it)
MODEL = HeatModel()


def record_feed(*args, **kwargs) -> None:
    MODEL.record_feed(*args, **kwargs)


def snapshot_rows(now_ns: Optional[int] = None) -> list[dict]:
    return MODEL.snapshot_rows(now_ns)


def top_shards(n: int = 10, now_ns: Optional[int] = None) -> list[tuple]:
    return MODEL.top_shards(n, now_ns)


def reset_for_testing() -> None:
    MODEL.reset()


def _skew_gauges() -> dict:
    return {(("table_name", t),): float(s) for t, s in MODEL.skew().items()}


metrics.register_gauge_fn(
    "px_shard_heat_skew", _skew_gauges,
    help_="per-table max/mean decayed shard heat (1.0 = even access; the "
          "shard rebalancer's trigger signal)")


class FeedRecorder:
    """Per-feed adapter the executor holds across one ``_feed`` stream: maps
    sealed-batch gens to age buckets (a snapshot read of the table's sealed
    list), then attributes every emitted coalesced part to its (tier,
    bucket) cell.  Constructed only when observe.enabled().

    The executor's feeds hold hundreds of storage batches (a 64M-row table
    is 1,024 of them), so the per-query cost is kept off the per-batch
    path: when the youngest and the oldest sealed batch fall in one age
    bucket, every batch does (`uniform`), and a feed of sealed gens is one
    bump whose bytes are its rows times the columns' item sizes — the same
    cells and counts as a bump a part.  The gen → bucket map is built only
    for a feed that spans buckets."""

    __slots__ = ("table_name", "shard", "model", "now_ns", "uniform", "_sealed",
                 "_has_time", "_gen_range", "_age_by_gen")

    def __init__(self, table, shard: str, model: Optional[HeatModel] = None,
                 now_ns: Optional[int] = None):
        self.table_name = str(getattr(table, "name", table))
        self.shard = str(shard or "local")
        self.model = model if model is not None else MODEL
        self.now_ns = int(now_ns if now_ns is not None else time.time_ns())
        self._sealed = list(getattr(table, "_sealed", ()) or ())
        self._has_time = getattr(table, "time_col", None) is not None
        self._age_by_gen = None
        self.uniform = None
        self._gen_range = None
        if not self._sealed:
            return
        lo, hi = self._sealed[0].gen, self._sealed[-1].gen
        if isinstance(lo, int) and isinstance(hi, int):
            self._gen_range = (lo, hi)  # a Table's gens rise without holes
        if not self._has_time:
            self.uniform = "sealed"
            return
        times = [b.max_time for b in self._sealed]
        if None in times:
            return
        young = age_bucket(max((self.now_ns - int(max(times))) / 1e9, 0.0))
        old = age_bucket(max((self.now_ns - int(min(times))) / 1e9, 0.0))
        if young == old:  # a bucket is monotone in a batch's max_time
            self.uniform = young

    @property
    def age_by_gen(self) -> dict:
        """{sealed gen: age bucket} at this recorder's now."""
        if self._age_by_gen is None:
            out = {}
            for b in self._sealed:
                age_s = None
                if self._has_time and b.max_time is not None:
                    age_s = max((self.now_ns - int(b.max_time)) / 1e9, 0.0)
                out[b.gen] = age_bucket(age_s)
            self._age_by_gen = out
        return self._age_by_gen

    def record(self, parts: list, gens: list, tier: str,
               rows: Optional[int] = None) -> None:
        """Attribute one emitted feed (the executor's coalesced `pend`
        batches) to the model: rows/bytes grouped by age bucket.  `rows`,
        where the caller knows it, is the feed's row count (the parts'
        first columns' lengths summed)."""
        pairs = [(p, g) for p, g in zip(parts, gens) if p] if rows is None \
            else [(p, g) for p, g in zip(parts[:1], gens[:1]) if p]
        if not pairs:
            return
        k0 = next(iter(pairs[0][0]))
        row_bytes = sum(int(v.dtype.itemsize) for v in pairs[0][0].values())
        rng = self._gen_range
        if (self.uniform is not None and rng is not None and None not in gens
                and all(isinstance(g, int) for g in (gens[0], gens[-1]))
                and rng[0] <= min(gens) and max(gens) <= rng[1]):
            if rows is None:
                rows = sum(len(p[k0]) for p, _g in pairs)
            self.model.record_feed(self.table_name, self.shard, rows, rows * row_bytes,
                                   tier, self.uniform, now_ns=self.now_ns)
            return
        pairs = [(p, g) for p, g in zip(parts, gens) if p]
        agg: dict[str, int] = {}
        ages = self.age_by_gen
        for part, gen in pairs:
            bucket = "hot" if gen is None else ages.get(gen, "sealed")
            agg[bucket] = agg.get(bucket, 0) + len(part[k0])
        for bucket, rows in agg.items():
            self.model.record_feed(self.table_name, self.shard, rows, rows * row_bytes,
                                   tier, bucket, now_ns=self.now_ns)

    def record_batch(self, rb, n_valid: int, gen,
                     tier: str = "stream") -> None:
        """Attribute one raw storage batch (the no-coalescing scan loops:
        np_partial's fused window, the wholeplan native pass)."""
        nbytes = sum(int(getattr(v, "nbytes", 0))
                     for v in getattr(rb, "columns", {}).values())
        bucket = "hot" if gen is None else self.age_by_gen.get(gen, "sealed")
        self.model.record_feed(self.table_name, self.shard, int(n_valid),
                               nbytes, tier, bucket, now_ns=self.now_ns)


# ------------------------------------------------------- storage-state fold


def _sealed_snapshot(table, now_ns: int) -> tuple[int, int, int, dict]:
    """(hot_rows, sealed_batches, sealed_bytes, age_histogram) from one
    table, under its seal lock (the fold runs on the metrics cron, not the
    query hot path).  Cold-tier entries (table.lifecycle._ColdBatch stubs
    whose data lives on disk) count in the batch total and age histogram
    but NOT in sealed_bytes — that column is host RAM; the disk side is
    reported as cold_bytes/cold_segments from the tier's own accounting."""
    with table._lock:
        sealed = list(table._sealed)
        hot_rows = int(table._hot_rows)
    has_time = table.time_col is not None
    nbytes = 0
    hist: dict[str, int] = {}
    for b in sealed:
        if not getattr(b, "is_cold", False) or b.in_ram:
            nbytes += int(b.nbytes)
        age_s = None
        if has_time and b.max_time is not None:
            age_s = max((now_ns - int(b.max_time)) / 1e9, 0.0)
        bucket = age_bucket(age_s)
        hist[bucket] = hist.get(bucket, 0) + 1
    return hot_rows, len(sealed), nbytes, hist


def _matview_bytes_by_table(matviews) -> dict[str, int]:
    out: dict[str, int] = {}
    if matviews is None:
        return out
    try:
        views = list(getattr(matviews, "_views", {}).values())
    except Exception:
        return out
    for v in views:
        tname = str(getattr(getattr(v, "table", None), "name", "") or "")
        out[tname] = out.get(tname, 0) + int(getattr(v, "state_bytes", 0))
    return out


def storage_state_rows(store, agent: str, now_ns: Optional[int] = None,
                       matviews=None, replication=None) -> list[dict]:
    """One self_telemetry.storage_state row per plain table in `store`:
    the agent's measured holdings (see STORAGE_STATE_RELATION).  Duck-typed
    over the matview manager and replication manager so the broker-less
    LocalCluster path folds the same rows."""
    from pixie_tpu_torch.engine import resident  # lazy: table/ must not pull jax
    from pixie_tpu_torch.table.table import Table

    now_ns = int(now_ns if now_ns is not None else time.time_ns())
    res_by_uid = resident.per_table_bytes()
    mv_bytes = _matview_bytes_by_table(matviews)
    lag: dict[str, int] = {}
    if replication is not None:
        try:
            lag = dict(replication.lag())
        except Exception:
            lag = {}
    peer_lag = json.dumps(lag, sort_keys=True) if lag else ""
    max_lag = max(lag.values(), default=0)

    rows = []
    for name in sorted(store.names()):
        t = store._tables.get(name)
        if not isinstance(t, Table):
            continue
        hot_rows, n_sealed, sealed_bytes, hist = _sealed_snapshot(t, now_ns)
        jbytes = jsegs = 0
        j = getattr(t, "journal", None)
        if j is not None:
            jbytes, jsegs = j.disk_usage()
        cbytes = csegs = 0
        tier = getattr(t, "cold", None)
        if tier is not None:
            cbytes, csegs = tier.disk_usage()
        rows.append({
            "time_": now_ns,
            "agent": str(agent),
            "table_name": name,
            "hot_rows": hot_rows,
            "sealed_batches": n_sealed,
            "sealed_bytes": sealed_bytes,
            "age_histogram": json.dumps(hist, sort_keys=True) if hist else "",
            "resident_bytes": int(res_by_uid.get(t.uid, 0)),
            "matview_bytes": int(mv_bytes.get(name, 0)),
            "journal_bytes": int(jbytes),
            "journal_segments": int(jsegs),
            "repl_lag_batches": int(max_lag),
            "peer_lag": peer_lag,
            "cold_bytes": int(cbytes),
            "cold_segments": int(csegs),
        })
    return rows


def fold_into(store, agent: str, now_ns: Optional[int] = None,
              matviews=None, replication=None) -> int:
    """The PL_SELF_METRICS_S cron body: write the decayed heat snapshot and
    the storage-state rows into `store` through the normal telemetry write
    path.  No-op (zero rows, zero table creation) when tracing is off."""
    from pixie_tpu_torch import observe

    if not observe.enabled():
        return 0
    n = observe.write_rows(store, observe.SHARD_HEAT_TABLE,
                           snapshot_rows(now_ns))
    state = storage_state_rows(store, agent, now_ns=now_ns,
                               matviews=matviews, replication=replication)
    n += observe.write_rows(store, observe.STORAGE_STATE_TABLE, state)
    metrics.gauge_set(
        "px_journal_bytes", float(sum(r["journal_bytes"] for r in state)),
        labels={"agent": metrics.capped_label("heat_shard", str(agent))},
        help_="journal bytes on disk per agent (PL_JOURNAL_MAX_MB pruning "
              "pressure)")
    return n
