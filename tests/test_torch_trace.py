"""The span API: pixie_tpu_torch.trace against pixie_tpu.trace.

The cases of tests/test_trace.py (span lifecycle and links, wire-context
parenting, the disabled flag, bounded buffers, error attributes, the spans
table, thread propagation, the HostBatch adapter, histograms and the buffer
gauges) run on the port; where a case produces data (the spans table, the
adapter's batch, the rendered metrics) the reference's run of the same
steps must produce the same values, ids and times aside.  The OTLP encoder
(engine/otel.py) is not ported: the port's flush counts an export error
where the reference's exports a payload.
"""
import json
import threading

import numpy as np
import pytest

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
from pixie_tpu import flags as ref_flags
from pixie_tpu import metrics as ref_metrics
from pixie_tpu import trace as ref_trace
from pixie_tpu.table import TableStore as RefStore

from pixie_tpu_torch import flags, metrics, trace
from pixie_tpu_torch.status import Unimplemented
from pixie_tpu_torch.table import TableStore


@pytest.fixture(autouse=True)
def _tracing_on():
    saved = flags.get("PL_TRACING_ENABLED"), ref_flags.get("PL_TRACING_ENABLED")
    flags.set_for_testing("PL_TRACING_ENABLED", True)
    ref_flags.set_for_testing("PL_TRACING_ENABLED", True)
    yield
    flags.set_for_testing("PL_TRACING_ENABLED", saved[0])
    ref_flags.set_for_testing("PL_TRACING_ENABLED", saved[1])


def test_span_lifecycle_and_links():
    tr = trace.Tracer("svc")
    with trace.root(tr, "query", req_id="q1") as root:
        assert root is not None
        assert trace.wire_context() == {
            "trace_id": root.trace_id, "span_id": root.span_id}
        with trace.span("compile") as child:
            assert child.trace_id == root.trace_id
            assert child.parent_span_id == root.span_id
            # nested child parents under the inner span
            with trace.span("inner") as inner:
                assert inner.parent_span_id == child.span_id
        assert trace.current()[1] is root  # context restored
    assert trace.current() is None
    assert tr.started == tr.finished == 3
    spans = tr.drain()
    assert sorted(s.name for s in spans) == ["compile", "inner", "query"]
    for s in spans:
        assert s.end_ns >= s.start_ns
        assert len(s.trace_id) == 32 and len(s.span_id) == 16


def test_remote_parenting_via_wire_context():
    broker, agent = trace.Tracer("broker"), trace.Tracer("agent")
    with trace.root(broker, "query"):
        wctx = trace.wire_context()
    with trace.root(agent, "exec", ctx=wctx) as sp:
        assert sp.trace_id == wctx["trace_id"]
        assert sp.parent_span_id == wctx["span_id"]


def test_no_context_means_no_spans():
    # child-site calls without an active root are no-ops
    with trace.span("orphan") as sp:
        assert sp is None
    assert trace.start_child("x") is None
    trace.event_span("y", 0, 1)
    assert trace.wire_context() is None


def test_disabled_flag_suppresses_roots():
    tr = trace.Tracer("svc")
    flags.set_for_testing("PL_TRACING_ENABLED", False)
    with trace.root(tr, "query") as sp:
        assert sp is None
        with trace.span("child") as c:
            assert c is None
    assert tr.started == 0


def test_buffer_bounds_and_drop_accounting():
    tr = trace.Tracer("svc", max_spans=3)
    for i in range(5):
        tr.finish(tr.start_span(f"s{i}"))
    assert tr.started == tr.finished == 5
    assert tr.dropped == 2
    assert tr.buffered == 3
    assert len(tr.drain()) == 3
    assert tr.buffered == 0


def test_error_exit_records_error_attribute():
    tr = trace.Tracer("svc")
    with pytest.raises(ValueError):
        with trace.root(tr, "query"):
            with trace.span("compile"):
                raise ValueError("boom")
    spans = {s.name: s for s in tr.drain()}
    assert "boom" in spans["compile"].attributes["error"]
    assert "boom" in spans["query"].attributes["error"]
    assert tr.started == tr.finished == 2


def _spans_table(store, mod) -> dict:
    t = store.table(mod.SPANS_TABLE)
    got = {}
    for rb, _rid, _gen in t.cursor():
        n = rb.num_valid
        for c in t.relation:
            arr = rb.columns[c.name][:n]
            vals = (t.dictionaries[c.name].decode(arr)
                    if c.name in t.dictionaries else arr.tolist())
            got.setdefault(c.name, []).extend(vals)
    return got


def _flush_steps(mod, store, exporter=None):
    """The reference case's steps: two spans flushed into `store`, with
    `exporter` set where given.  Returns the flushed rows."""
    tr = mod.Tracer("svc", exporter=exporter)
    with mod.root(tr, "query", user="alice"):
        with mod.span("step"):
            pass
    return tr.flush(store=store)


def test_flush_writes_table_and_counts_the_unported_otlp_export():
    store = TableStore()
    rows = _flush_steps(trace, store)
    assert len(rows) == 2
    got = _spans_table(store, trace)
    assert sorted(got["name"]) == ["query", "step"]
    assert set(got["service"]) == {"svc"}
    assert all(d >= 0 for d in got["duration_ns"])
    attrs = [json.loads(a) for a in got["attributes"] if a]
    assert {"user": "alice"} in attrs
    # the encoder (engine/otel.py) is not ported: an exporter is refused up
    # front, and so is the encoding
    with pytest.raises(Unimplemented, match="6e"):
        trace.Tracer("svc", exporter=lambda payload: None)
    with pytest.raises(Unimplemented, match="6e"):
        trace.spans_to_otlp(rows)
    assert trace.spans_to_otlp([]) == {}
    assert "PL_TRACE_OTLP_URL" not in flags.dump()
    # the reference's same steps, exporting, write the same table, ids and
    # times aside
    ref_store = RefStore()
    ref_payloads = []
    ref_rows = _flush_steps(ref_trace, ref_store, exporter=ref_payloads.append)
    want = _spans_table(ref_store, ref_trace)
    assert len(ref_payloads) == 1
    assert [c.name for c in store.table(trace.SPANS_TABLE).relation] == list(want)
    for col in ("name", "service", "attributes"):
        assert sorted(got[col]) == sorted(want[col]), col
    assert sorted(rows[0]) == sorted(ref_rows[0])


def test_thread_propagation_helper():
    tr = trace.Tracer("svc")
    seen = {}

    def work():
        c = trace.current()
        seen["ctx"] = c and c[1].name

    with trace.root(tr, "query"):
        call = trace.propagating_call(work)
        th = threading.Thread(target=call)
        th.start()
        th.join()
    assert seen["ctx"] == "query"


def test_tracer_thread_safety():
    tr = trace.Tracer("svc", max_spans=10_000)

    def worker():
        for _ in range(500):
            tr.finish(tr.start_span("s"))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert tr.started == tr.finished == 4000
    assert tr.buffered + tr.dropped == 4000


def test_spans_to_host_batch_adapter():
    tr = trace.Tracer("svc")
    with trace.root(tr, "query"):
        pass
    rows = [s.to_row() for s in tr.drain()]
    hb = trace.spans_to_host_batch(rows)
    assert hb.num_rows == 1
    assert set(hb.cols) == {"time_", "trace_id", "span_id", "parent_span_id",
                            "name", "service", "duration_ns", "attributes",
                            "end_time_"}
    assert int(hb.cols["end_time_"][0]) == rows[0]["time_"] + rows[0][
        "duration_ns"]
    want = ref_trace.spans_to_host_batch(rows)
    assert {k: v.name for k, v in hb.dtypes.items()} == \
        {k: v.name for k, v in want.dtypes.items()}
    for name, col in want.cols.items():
        if name in want.dicts:
            assert hb.dicts[name].decode(hb.cols[name]) == want.dicts[name].decode(col)
        else:
            np.testing.assert_array_equal(hb.cols[name], np.asarray(col))


# ------------------------------------------------------------- histograms


def _histogram_text(mod) -> str:
    mod.reset_for_testing()
    try:
        for v in (0.003, 0.04, 0.04, 9.0):
            mod.histogram_observe("lat_seconds", v, (0.01, 0.1, 1.0), help_="latency")
        return mod.render()
    finally:
        mod.reset_for_testing()


def test_histogram_rendering():
    text = _histogram_text(metrics)
    assert '# TYPE lat_seconds histogram' in text
    assert 'lat_seconds_bucket{le="0.01"} 1' in text
    assert 'lat_seconds_bucket{le="0.1"} 3' in text  # cumulative
    assert 'lat_seconds_bucket{le="1"} 3' in text
    assert 'lat_seconds_bucket{le="+Inf"} 4' in text
    assert 'lat_seconds_count 4' in text
    np.testing.assert_allclose(
        float([ln for ln in text.splitlines()
               if ln.startswith("lat_seconds_sum")][0].split()[-1]),
        9.083)
    assert text == _histogram_text(ref_metrics)


def test_histogram_rejects_bound_redeclaration():
    metrics.reset_for_testing()
    try:
        metrics.histogram_observe("h", 1.0, (1.0, 2.0))
        with pytest.raises(ValueError):
            metrics.histogram_observe("h", 1.0, (1.0, 3.0))
        with pytest.raises(ValueError):
            metrics.histogram_observe("h2", 1.0, (2.0, 1.0))
    finally:
        metrics.reset_for_testing()


def test_span_buffer_gauges():
    metrics.reset_for_testing()  # register_gauges re-registers after a reset
    try:
        trace.register_gauges()
        tr = trace.Tracer("gsvc")
        with trace.root(tr, "query"):
            pass
        text = metrics.render()
        assert 'px_trace_spans_started{service="gsvc"} 1' in text
        assert 'px_trace_spans_finished{service="gsvc"} 1' in text
        assert 'px_trace_buffer_spans{service="gsvc"} 1' in text
        assert 'px_trace_spans_dropped{service="gsvc"} 0' in text
    finally:
        metrics.reset_for_testing()


def test_matview_spans_land_under_a_root():
    """The views' spans (matview_refresh, matview_hit) parent under an
    active root, and the fold executor's operator span under the refresh,
    as the reference's agent records them."""
    from pixie_tpu_torch.matview import MatViewManager
    from pixie_tpu_torch.plan import AggExpr, AggOp, MemorySourceOp, Plan, ResultSinkOp
    from pixie_tpu_torch.types import DataType as DT, Relation

    ts = TableStore()
    ts.create("t", Relation.of(("time_", DT.TIME64NS), ("k", DT.INT64)),
              batch_rows=256).write({"time_": np.arange(1000, dtype=np.int64),
                                     "k": np.arange(1000, dtype=np.int64) % 7})
    p = Plan()
    src = p.add(MemorySourceOp(table="t"))
    agg = p.add(AggOp(groups=["k"], values=[AggExpr("n", "count", None)], partial=True),
                parents=[src])
    p.add(ResultSinkOp(channel="mv", payload="agg_state"), parents=[agg])
    mgr = MatViewManager(ts, device="cpu")
    tr = trace.Tracer("agent")
    with trace.root(tr, "exec") as root:
        assert mgr.serve(p) is None
        assert mgr.serve(p) is not None
    spans = {s.name: s for s in tr.drain()}
    assert set(spans) == {"exec", "matview_refresh", "matview_hit", "scan(t)->partial_agg"}
    assert spans["matview_refresh"].parent_span_id == root.span_id
    assert spans["scan(t)->partial_agg"].parent_span_id == spans["matview_refresh"].span_id
    assert spans["matview_hit"].attributes["rows_folded"] == 1000
