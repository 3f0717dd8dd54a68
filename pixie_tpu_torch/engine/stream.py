"""Streaming query execution: incremental polls with carried window state.

Reference semantics: `stream()`/`rolling` dataframes run indefinitely, row
batches carry end-of-window / end-of-stream markers (exec_node.h:213-219), and
windowed aggregates emit each window's rows when it closes (agg_node.h:88-91
eow/eos emission).

The host drives polls, the device does the math:

  * Each sink pipeline keeps a row-id resume token per streaming source; a
    poll compiles the SAME chain programs as batch execution (kernel C1 on
    the card: the window origin is a runtime scalar, so a new poll reuses
    the program) but scans only the appended delta (Table.cursor_since).
  * A blocking aggregate fed by a streaming chain runs as a PARTIAL aggregate
    per poll (the distributed machinery reused verbatim: the poll is a
    "producer", the stream state is the running combine_partials result).
    Value-keyed state makes polls mergeable even when each poll's private
    code spaces differ.
  * Window close = event-time watermark passes window end.  Window keys are
    aligned `px.bin` bins, so the newest seen bin start IS the watermark bin:
    every strictly-older window has ended.  `lateness_ns` keeps recent windows
    open longer; rows for already-emitted windows are dropped (exactly-once
    emission).
  * Non-windowed streaming aggregates follow reference semantics: they only
    emit at end-of-stream (close()).

Copied from the reference package (pixie_tpu/engine/stream.py).  Polls run
on the StreamQuery's device (CUDA unless the caller asks for another; the
reference pins them to its CPU backend).  Emissions carry the logical
plan's semantic types (engine/semantics.py restamp_result, computed once a
sink), as the reference's do.  This module is single-store
(agent-local); parallel/streaming.py composes per-agent StreamQueries.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from pixie_tpu_torch.engine.executor import HostBatch, PlanExecutor, resolve_device
from pixie_tpu_torch.engine.result import QueryResult
from pixie_tpu_torch.engine.semantics import restamp_result
from pixie_tpu_torch.plan.plan import (
    AggOp,
    Call,
    Column,
    FilterOp,
    LimitOp,
    Literal,
    MapOp,
    MemorySinkOp,
    MemorySourceOp,
    Plan,
    RemoteSourceOp,
    ResultSinkOp,
)
from pixie_tpu_torch.status import Unimplemented

_STREAMABLE = (MapOp, FilterOp, LimitOp)


def _window_width(chain, agg: AggOp, time_col: Optional[str]) -> tuple[Optional[str], int]:
    """(window key name, width ns) if some agg group is a px.bin over the
    SOURCE TIME column.  Bins over value columns must not get watermark
    semantics — they aggregate like any other group (emit at close)."""
    if time_col is None:
        return None, 0
    for op in chain:
        if not isinstance(op, MapOp):
            continue
        for name, expr in op.exprs:
            if (
                name in agg.groups
                and isinstance(expr, Call)
                and expr.fn == "bin"
                and len(expr.args) == 2
                and isinstance(expr.args[0], Column)
                and expr.args[0].name == time_col
                and isinstance(expr.args[1], Literal)
            ):
                return name, int(expr.args[1].value)
    return None, 0


@dataclasses.dataclass
class _Pipeline:
    """One sink's streaming pipeline."""

    sink_name: str
    source: MemorySourceOp  # the cloned source whose row-id bounds we patch
    fragment: Plan  # source→chain→(sink | partial agg→resultsink)
    post: Optional[Plan]  # RemoteSource→post ops→sink (agg pipelines)
    agg: Optional[AggOp]
    window_key: Optional[str]
    window_ns: int
    token: int = 0
    acc: object = None  # running PartialAggBatch (agg pipelines)
    watermark_bin: Optional[int] = None
    emitted_below: Optional[int] = None  # window starts < this were emitted
    limit_ids: list = dataclasses.field(default_factory=list)
    remaining: dict = dataclasses.field(default_factory=dict)
    done: bool = False


class StreamQuery:
    """Incremental executor for plans whose sources are streaming.

    poll()  → {sink_name: QueryResult} for anything newly emitted.
    close() → final emissions (end-of-stream flush of open windows /
              non-windowed aggregates); marks the stream done.
    """

    CHANNEL = "__stream"

    def __init__(self, plan: Plan, store, registry=None, lateness_ns: int = 0,
                 device=None):
        from pixie_tpu_torch.udf import registry as default_registry

        self.store = store
        self.registry = registry or default_registry
        self.lateness_ns = int(lateness_ns)
        #: every poll's executor runs here (CUDA unless asked otherwise)
        self.device = resolve_device(device)
        self.closed = False
        #: per-sink end tokens snapshotted by freeze(); None = live (polls
        #: read to the table head).  Bounds close() under concurrent writers.
        self._ends: Optional[dict] = None
        #: the logical plan — kept for semantic-type restamping of emissions
        #: (post plans read a channel source with no ST knowledge)
        self.plan = plan
        #: sink name → ST-stamped relation, computed once (constant per sink)
        self._st_rel_cache: dict[str, object] = {}
        #: the executors' exec_stats summed over this stream's polls
        self.stats: dict = {}
        self.pipelines: list[_Pipeline] = []
        for sink in plan.sinks():
            if not isinstance(sink, MemorySinkOp):
                raise Unimplemented(f"streaming sink {sink.kind}")
            self.pipelines.append(self._build_pipeline(plan, sink))

    # ------------------------------------------------------------ construction
    def _build_pipeline(self, plan: Plan, sink: MemorySinkOp) -> _Pipeline:
        # Walk up: sink ← post-chain ← [agg] ← chain ← source
        post_ops = []
        cur = plan.parents(sink)[0]
        while isinstance(cur, _STREAMABLE):
            post_ops.append(cur)
            cur = plan.parents(cur)[0]
        post_ops.reverse()

        if isinstance(cur, MemorySourceOp):
            # pure chain pipeline
            frag = Plan()
            src = dataclasses.replace(cur, id=-1)
            node = frag.add(src)
            limit_ids = []
            for op in post_ops:
                c = dataclasses.replace(op, id=-1)
                node = frag.add(c, parents=[node])
                if isinstance(c, LimitOp):
                    limit_ids.append(c.id)
            frag.add(
                MemorySinkOp(name=sink.name, columns=sink.columns), parents=[node]
            )
            pl = _Pipeline(
                sink_name=sink.name, source=src, fragment=frag, post=None,
                agg=None, window_key=None, window_ns=0, limit_ids=limit_ids,
            )
            for lid in limit_ids:
                pl.remaining[lid] = frag.op(lid).n
            return pl

        if not isinstance(cur, AggOp):
            raise Unimplemented(
                f"streaming supports chain and single-agg plans, got {cur.kind}"
            )
        agg = cur
        chain = []
        cur = plan.parents(agg)[0]
        while isinstance(cur, _STREAMABLE):
            chain.append(cur)
            cur = plan.parents(cur)[0]
        chain.reverse()
        if not isinstance(cur, MemorySourceOp):
            raise Unimplemented(
                "streaming agg must be fed by a source chain "
                f"(got {cur.kind} upstream)"
            )
        if any(isinstance(op, LimitOp) for op in chain):
            raise Unimplemented("limit upstream of a streaming aggregate")

        frag = Plan()
        src = dataclasses.replace(cur, id=-1)
        node = frag.add(src)
        for op in chain:
            node = frag.add(dataclasses.replace(op, id=-1), parents=[node])
        partial = dataclasses.replace(agg, id=-1, partial=True)
        node = frag.add(partial, parents=[node])
        frag.add(ResultSinkOp(channel=self.CHANNEL, payload="agg_state"), parents=[node])

        post = Plan()
        pnode = post.add(RemoteSourceOp(channel=self.CHANNEL))
        for op in post_ops:
            pnode = post.add(dataclasses.replace(op, id=-1), parents=[pnode])
        post.add(MemorySinkOp(name=sink.name, columns=sink.columns), parents=[pnode])

        wkey, wns = _window_width(
            chain, agg, self.store.table(src.table).time_col
        )
        return _Pipeline(
            sink_name=sink.name, source=src, fragment=frag, post=post,
            agg=dataclasses.replace(agg, id=-1), window_key=wkey, window_ns=wns,
        )

    # ------------------------------------------------------------------- drive
    #: per-poll delta cap: bounds per-poll latency and amortizes the fixed
    #: per-poll dispatch cost
    MAX_POLL_ROWS = 1 << 23

    def poll(self) -> dict[str, QueryResult]:
        """Process rows appended since the last poll (up to MAX_POLL_ROWS per
        pipeline); return new emissions."""
        if self.closed:
            return {}
        out: dict[str, QueryResult] = {}
        for pl in self.pipelines:
            got = self._poll_pipeline(pl)
            if got is not None:
                out[pl.sink_name] = got
        return out

    def lagging(self) -> bool:
        """True if any pipeline has unprocessed rows (poll again, don't wait)."""
        for pl in self.pipelines:
            if pl.done:
                continue
            if self._bounded_last(pl) > pl.token:
                return True
        return False

    def freeze(self) -> None:
        """Snapshot per-pipeline end tokens: later polls stop at rows that
        exist NOW.  Without this, close()'s drain loop re-reads the live
        table head each iteration and never terminates against a writer
        sustaining more than MAX_POLL_ROWS per poll."""
        if self._ends is None:
            self._ends = {
                pl.sink_name: self.store.table(pl.source.table).last_row_id()
                for pl in self.pipelines
            }

    def _end_for(self, pl) -> Optional[int]:
        return None if self._ends is None else self._ends.get(pl.sink_name)

    def _bounded_last(self, pl) -> int:
        """Newest row id this pipeline may read: the live table head, clamped
        to the freeze() end token once one exists."""
        last = self.store.table(pl.source.table).last_row_id()
        end = self._end_for(pl)
        return last if end is None else min(last, end)

    def close(self) -> dict[str, QueryResult]:
        """End of stream: drain everything unprocessed (up to the rows that
        existed at close entry), then flush open windows / non-windowed agg
        state."""
        self.freeze()
        out = self.poll()
        while self.lagging():
            got = self.poll()
            for name, res in got.items():
                out[name] = (_concat_results(out[name], res)
                             if name in out else res)
        self.closed = True
        for pl in self.pipelines:
            if pl.agg is None or pl.acc is None:
                continue
            hb = self._finalize(pl, pl.acc)
            pl.acc = None
            got = self._run_post(pl, hb)
            if got is not None:
                if pl.sink_name in out:
                    out[pl.sink_name] = _concat_results(out[pl.sink_name], got)
                else:
                    out[pl.sink_name] = got
        return out

    # ---------------------------------------------------------------- plumbing
    def _executor(self, plan: Plan, inputs=None) -> PlanExecutor:
        # polls run on one device (mesh=None), as the reference's do, and bin
        # a NaN sketch value at 0, as its CPU route (force_backend="cpu",
        # pixie_tpu/engine/stream.py:298, :351) bins it; the post plan over
        # a poll's emissions keeps the batch rule.  Polls keep the card
        # route whatever their size (force_backend="device"): the port does
        # not move them to the host fast paths
        poll = inputs is None
        return PlanExecutor(plan, self.store, self.registry, device=self.device,
                            inputs=inputs, mesh=None if poll else "auto",
                            nan_bin=0 if poll else 1,
                            force_backend="device" if poll else None)

    def _count(self, ex: PlanExecutor) -> None:
        for k, v in ex.stats.items():
            if isinstance(v, int):
                self.stats[k] = self.stats.get(k, 0) + v

    def _poll_pipeline(self, pl: _Pipeline) -> Optional[QueryResult]:
        if pl.done:
            return None
        hi = min(self._bounded_last(pl), pl.token + self.MAX_POLL_ROWS)
        if hi <= pl.token:
            return None
        pl.source.since_row_id = pl.token
        pl.source.stop_row_id = hi
        # NOTE: pl.token only advances after a successful run — a transient
        # execution failure must not silently skip the delta.

        if pl.agg is None:
            # chain pipeline: patch carried limit budgets into this poll's run
            for lid in pl.limit_ids:
                pl.fragment.op(lid).n = pl.remaining[lid]
            ex = self._executor(pl.fragment)
            res = ex.run()[pl.sink_name]
            self._count(ex)
            pl.token = hi
            if pl.limit_ids:
                # Budgets decrement by rows CONSUMED at each limit step (the
                # executor surfaces them) — not by emitted rows, which a
                # downstream filter can shrink.
                rem = next(
                    (
                        r["limit_remaining"]
                        for r in reversed(ex.op_stats)
                        if "limit_remaining" in r
                    ),
                    None,
                )
                if rem is not None:
                    for lid, left in zip(pl.limit_ids, rem):
                        pl.remaining[lid] = max(0, int(left))
                if min(pl.remaining.values()) <= 0:
                    pl.done = True  # eos: limit exhausted
            return res if res.num_rows else None

        # agg pipeline: run the partial fragment over the delta, merge into acc
        from pixie_tpu_torch.parallel.partial import combine_partials

        pb = self._poll_delta(pl)
        parts = [p for p in (pl.acc, pb) if p is not None]
        pl.acc = combine_partials(pl.agg, parts, self.registry)

        if pl.window_key is None:
            return None  # non-windowed: emits at close() only

        wvals = np.asarray(pl.acc.key_cols[pl.window_key], dtype=np.int64)
        if len(wvals) == 0:
            return None
        new_max = int(wvals.max())
        if pl.watermark_bin is None or new_max > pl.watermark_bin:
            pl.watermark_bin = new_max
        # close every window strictly older than (newest bin - lateness)
        emit, pl.acc, pl.emitted_below = split_closing_windows(
            pl.acc, pl.window_key, pl.watermark_bin - self.lateness_ns,
            pl.emitted_below,
        )
        if emit is None:
            return None
        hb = self._finalize(pl, emit)
        return self._run_post(pl, hb)

    def _poll_delta(self, pl: _Pipeline):
        """Run the partial agg fragment over this poll's row-id delta.
        Caller must have set pl.source.since/stop_row_id; advances the token
        on success.  Returns the delta PartialAggBatch."""
        ex = self._executor(pl.fragment)
        pb = ex.run_agent()[self.CHANNEL]
        self._count(ex)
        pl.token = pl.source.stop_row_id
        return pb

    def poll_partials(self) -> dict[str, object]:
        """Distributed streaming hook: {sink_name: PartialAggBatch delta} for
        each agg pipeline with new rows this poll.  The caller (cluster
        stream) owns accumulation, watermarking, and emission — this side
        ships deltas only, exactly like a distributed agent's partial channel.
        """
        out = {}
        for pl in self.pipelines:
            if pl.agg is None:
                continue  # chain pipelines stream rows via poll()
            hi = min(self._bounded_last(pl), pl.token + self.MAX_POLL_ROWS)
            if hi <= pl.token:
                continue
            pl.source.since_row_id = pl.token
            pl.source.stop_row_id = hi
            out[pl.sink_name] = self._poll_delta(pl)
        return out

    def _finalize(self, pl: _Pipeline, pb) -> HostBatch:
        from pixie_tpu_torch.parallel.partial import finalize_partial

        return finalize_partial(pl.agg, pb, self.registry)

    def _run_post(self, pl: _Pipeline, hb: HostBatch) -> Optional[QueryResult]:
        ex = self._executor(pl.post, inputs={self.CHANNEL: hb})
        res = ex.run()[pl.sink_name]
        if not res.num_rows:
            return None
        restamp_cached(res, self._st_rel_cache, pl.sink_name, self.plan, self.store,
                       self.registry)
        return res


def restamp_cached(res: QueryResult, cache: dict, sink_name: str, plan, store,
                   registry) -> None:
    """Stamp an emission's relation with the logical plan's semantic types:
    once a sink (the relation is constant per sink), then from `cache`."""
    rel = cache.get(sink_name)
    if rel is not None and rel.names() == res.relation.names():
        res.relation = rel  # constant per sink; skip the plan walk
    else:
        restamp_result(res, plan, store, registry)
        cache[sink_name] = res.relation


def split_closing_windows(acc, window_key: str, close_below: int,
                          emitted_below: Optional[int]):
    """Exactly-once window-close step shared by single-store and cluster
    streaming: drop groups for already-emitted windows (late data), split off
    groups whose window start < close_below.

    Returns (emit_pb | None, new_acc, new_emitted_below)."""
    from pixie_tpu_torch.parallel.partial import slice_partial

    wvals = np.asarray(acc.key_cols[window_key], dtype=np.int64)
    if emitted_below is not None:
        stale = wvals < emitted_below
        if stale.any():
            acc = slice_partial(acc, np.nonzero(~stale)[0])
            wvals = wvals[~stale]
    closing = wvals < close_below
    if not closing.any():
        return None, acc, emitted_below
    emit = slice_partial(acc, np.nonzero(closing)[0])
    acc = slice_partial(acc, np.nonzero(~closing)[0])
    return emit, acc, close_below


def stream_pxl(
    source: str,
    store,
    registry=None,
    lateness_ns: int = 0,
    now: Optional[int] = None,
    func: Optional[str] = None,
    func_args: Optional[dict] = None,
    device=None,
) -> StreamQuery:
    """Compile a PxL script with stream()/rolling semantics into a StreamQuery
    whose polls run on `device` (CUDA unless given)."""
    from pixie_tpu_torch.compiler import compile_pxl

    q = compile_pxl(
        source, store.schemas(), func=func, func_args=func_args,
        registry=registry, now=now,
    )
    return StreamQuery(q.plan, store, registry=registry, lateness_ns=lateness_ns,
                       device=device)


def _concat_results(a: QueryResult, b: QueryResult) -> QueryResult:
    """Append two emissions for the same sink (same relation by construction)."""
    from pixie_tpu_torch.engine.eval import apply_lut_np
    from pixie_tpu_torch.table.dictionary import Dictionary

    cols, dicts = {}, {}
    for n in a.relation.names():
        da, db = a.dictionaries.get(n), b.dictionaries.get(n)
        if da is not None:
            target = Dictionary(da.values())
            lut = db.translate_to(target, insert=True)
            cols[n] = np.concatenate([a.columns[n], apply_lut_np(lut, b.columns[n])])
            dicts[n] = target
        else:
            cols[n] = np.concatenate([a.columns[n], b.columns[n]])
    return QueryResult(
        name=a.name, relation=a.relation, columns=cols, dictionaries=dicts,
        exec_stats=dict(a.exec_stats),
    )
