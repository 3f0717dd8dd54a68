"""Distributed streaming queries over a cluster.

The single-store StreamQuery (engine.stream) already runs each poll as a
"producer shipping a value-keyed partial"; this composes N of them — one per
data agent — with a merger that owns accumulation, the GLOBAL watermark, and
emission:

  * each agent polls only its own appended row-id delta (agent-local cursors,
    reference: per-PEM streaming MemorySource);
  * the merger combines deltas into open value-keyed window state
    (combine_partials — the Kelvin-finalize analog, incremental);
  * a window closes when EVERY participating agent's event-time watermark has
    passed it (min-watermark rule: a lagging agent can still deliver rows for
    an old window; closing on the fastest agent would drop them).  An agent
    that has not produced ANY data yet holds the watermark — no window closes
    until every participant has spoken (close() always flushes; drop idle
    agents from the cluster if they should not gate emission).

Chain (non-agg) streaming pipelines simply union per-agent row emissions.

Copied from the reference package (pixie_tpu/parallel/streaming.py).  Every
agent's polls run on the cluster's one device (LocalCluster.device); the
agents poll in turn.  Emissions carry the logical plan's semantic types,
as in engine/stream.py, and tracepoint mutations are refused as
LocalCluster.query refuses them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from pixie_tpu_torch.engine.executor import PlanExecutor
from pixie_tpu_torch.engine.result import QueryResult
from pixie_tpu_torch.engine.stream import StreamQuery, _concat_results, restamp_cached
from pixie_tpu_torch.parallel.partial import combine_partials
from pixie_tpu_torch.status import Unimplemented


class _SinkState:
    def __init__(self):
        self.acc = None
        self.watermark_bin: dict[str, int] = {}  # agent -> max window start
        self.emitted_below: Optional[int] = None


class ClusterStreamQuery:
    """Streaming ExecuteScript over a LocalCluster."""

    def __init__(self, cluster, pxl_source: str, lateness_ns: int = 0,
                 now: Optional[int] = None):
        from pixie_tpu_torch.compiler import compile_pxl

        self.cluster = cluster
        self.lateness_ns = int(lateness_ns)
        q = compile_pxl(pxl_source, cluster.schemas(), now=now,
                        registry=cluster.registry)
        if q.mutations:
            raise Unimplemented("tracepoint mutations are not ported yet "
                                "(ROADMAP Queue 1 item 6e)")
        # Participating agents = those whose store holds every streamed source
        # table (heterogeneous clusters: the batch planner prunes the same way)
        src_tables = {
            op.table for op in q.plan.ops()
            if type(op).__name__ == "MemorySourceOp"
        }
        self._agent_sqs = {
            name: StreamQuery(q.plan, store, registry=cluster.registry,
                              device=cluster.device)
            for name, store in cluster.stores.items()
            if all(store.has(t) for t in src_tables)
        }
        if not self._agent_sqs:
            raise Unimplemented(
                f"no agent holds all streamed tables {sorted(src_tables)}"
            )
        # pipelines are structurally identical across agents; use one agent's
        # as the reference for post-plans / window metadata
        ref = next(iter(self._agent_sqs.values()))
        self._ref = ref
        #: sink name → ST-stamped relation, computed once (constant per sink)
        self._st_rel_cache: dict[str, object] = {}
        self._state: dict[str, _SinkState] = {
            pl.sink_name: _SinkState() for pl in ref.pipelines if pl.agg is not None
        }
        if any(pl.agg is None and pl.limit_ids for pl in ref.pipelines):
            raise Unimplemented("limits in distributed streaming chains")
        self.closed = False

    # ---------------------------------------------------------------- polling
    def poll(self) -> dict[str, QueryResult]:
        if self.closed:
            return {}
        out: dict[str, QueryResult] = {}
        # chain pipelines: per-agent row emissions, unioned
        for i, pl in enumerate(self._ref.pipelines):
            if pl.agg is not None:
                continue
            got = None
            for name, sq in self._agent_sqs.items():
                r = sq._poll_pipeline(sq.pipelines[i])
                if r is not None:
                    got = r if got is None else _concat_results(got, r)
            if got is not None:
                out[pl.sink_name] = got
        # agg pipelines: deltas → merged acc → min-watermark window close
        deltas: dict[str, list] = {s: [] for s in self._state}
        for name, sq in self._agent_sqs.items():
            for sink_name, pb in sq.poll_partials().items():
                deltas[sink_name].append((name, pb))
        for i, pl in enumerate(self._ref.pipelines):
            if pl.agg is None:
                continue
            st = self._state[pl.sink_name]
            got = self._advance_sink(pl, st, deltas[pl.sink_name])
            if got is not None:
                out[pl.sink_name] = got
        return out

    @property
    def stats(self) -> dict:
        """The agents' poll executors' exec_stats, summed."""
        out: dict = {}
        for sq in self._agent_sqs.values():
            for k, v in sq.stats.items():
                out[k] = out.get(k, 0) + v
        return out

    def _advance_sink(self, pl, st: _SinkState, agent_deltas) -> Optional[QueryResult]:
        from pixie_tpu_torch.engine.stream import split_closing_windows

        reg = self._ref.registry
        pbs = []
        for agent, pb in agent_deltas:
            if pl.window_key is not None and pb.num_groups:
                w = np.asarray(pb.key_cols[pl.window_key], dtype=np.int64)
                st.watermark_bin[agent] = max(
                    st.watermark_bin.get(agent, np.iinfo(np.int64).min), int(w.max())
                )
            pbs.append(pb)
        if pbs:
            st.acc = combine_partials(
                pl.agg, [p for p in (st.acc, *pbs) if p is not None], reg
            )
        if pl.window_key is None or st.acc is None:
            return None  # non-windowed: close() only
        # min-watermark across ALL participants: an agent with no data yet
        # holds every window open (no silent drops of its late first rows)
        if set(st.watermark_bin) != set(self._agent_sqs):
            return None
        close_below = min(st.watermark_bin.values()) - self.lateness_ns
        emit, st.acc, st.emitted_below = split_closing_windows(
            st.acc, pl.window_key, close_below, st.emitted_below
        )
        if emit is None:
            return None
        return self._emit(pl, emit)

    def _emit(self, pl, pb) -> Optional[QueryResult]:
        from pixie_tpu_torch.parallel.partial import finalize_partial

        hb = finalize_partial(pl.agg, pb, self._ref.registry)
        ex = PlanExecutor(
            pl.post, self.cluster.merger_store, self._ref.registry,
            device=self.cluster.device, inputs={StreamQuery.CHANNEL: hb},
        )
        res = ex.run()[pl.sink_name]
        if not res.num_rows:
            return None
        restamp_cached(res, self._st_rel_cache, pl.sink_name, self._ref.plan,
                       self._ref.store, self._ref.registry)
        return res

    def lagging(self) -> bool:
        """True while any agent has unprocessed rows (per-poll deltas are
        capped at StreamQuery.MAX_POLL_ROWS)."""
        return any(sq.lagging() for sq in self._agent_sqs.values())

    def close(self) -> dict[str, QueryResult]:
        # Freeze every agent's end tokens first: the drain below must target
        # the rows that exist NOW, not chase concurrent writers forever.
        for sq in self._agent_sqs.values():
            sq.freeze()
        out = self.poll()
        # Drain everything left behind the per-poll cap before flushing —
        # one poll is no longer guaranteed to reach last_row_id.
        while self.lagging():
            got = self.poll()
            for name, res in got.items():
                out[name] = (_concat_results(out[name], res)
                             if name in out else res)
        self.closed = True
        for pl in self._ref.pipelines:
            if pl.agg is None:
                continue
            st = self._state[pl.sink_name]
            if st.acc is None or not st.acc.num_groups:
                continue
            got = self._emit(pl, st.acc)
            st.acc = None
            if got is not None:
                if pl.sink_name in out:
                    out[pl.sink_name] = _concat_results(out[pl.sink_name], got)
                else:
                    out[pl.sink_name] = got
        return out
