"""Fault-tolerant query execution: the failure matrix, run against the
port's broker and agents on the CPU (tests/test_fault_tolerance.py's cases
of the same name; the straggler's stall ends on an event, not a clock).

Agent eviction → re-plan + re-dispatch under fresh tokens (bit-equal
recovery), straggler hedging with idempotent loser discard, retry budgets
(broker + client), registry incarnation fencing, and the deterministic
fault-injection layer.  Reference analog: the query broker's producer
watchdogs + the PEM churn assumptions (k8s nodes die mid-query).
"""
import dataclasses
import threading
import time

import numpy as np
import pytest

from pixie_tpu_torch import flags, metrics
from pixie_tpu_torch.engine.executor import PlanExecutor
from pixie_tpu_torch.plan.plan import Plan
from pixie_tpu_torch.services import faultinject, wire
from test_torch_services import Agent  # the port's, on the CPU
from test_torch_services import Broker  # the port's, on the CPU
from pixie_tpu.services.chaos_bench import canonical_bytes  # duck-typed over results
from pixie_tpu_torch.services.client import Client, QueryError
from pixie_tpu_torch.status import InvalidArgument
from pixie_tpu_torch.table import TableStore
from pixie_tpu_torch.types import DataType as DT, Relation

AGG_SCRIPT = """
df = px.DataFrame(table='http_events')
df = df.groupby('service').agg(cnt=('latency', px.count), m=('latency', px.mean))
px.display(df, 'out')
"""

MUTATION_SCRIPT = '''
import pxtrace
import px

program = """kprobe:x { printf("time_:%llu pid:%u", nsecs, pid); }"""

def probe():
    pxtrace.UpsertTracepoint('ft_probe', 'ft_probe_table', program,
                             pxtrace.kprobe(), "10m")
    df = px.DataFrame(table='ft_probe_table')
    return df
'''

FT_FLAGS = ("PL_QUERY_RETRIES", "PL_RETRY_BACKOFF_MS", "PL_CLIENT_RETRIES",
            "PL_REJOIN_GRACE_S", "PL_HEDGE_ENABLED", "PL_HEDGE_MIN_MS",
            "PL_HEDGE_FACTOR")


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = {n: flags.get(n) for n in FT_FLAGS}
    yield
    for n, v in saved.items():
        flags.set_for_testing(n, v)
    faultinject.uninstall()


def _mkstore(seed, n=20_000):
    rng = np.random.default_rng(seed)
    ts = TableStore()
    rel = Relation.of(
        ("time_", DT.TIME64NS), ("service", DT.STRING),
        ("latency", DT.FLOAT64), ("status", DT.INT64),
    )
    t = ts.create("http_events", rel, batch_rows=4096)
    t.write({
        "time_": np.arange(n, dtype=np.int64) * 1000,
        "service": rng.choice(["cart", "auth", "web"], n).tolist(),
        "latency": rng.exponential(20.0, n),
        "status": rng.choice([200, 500], n),
    })
    return ts


class _DieOnceAgent(Agent):
    """Sends one chunk frame on its first execute, then drops the
    connection — mid-stream producer death.  Later incarnations (or later
    executes) run normally."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.died = False

    def _execute(self, meta):
        if self.died:
            return super()._execute(meta)
        self.died = True
        plan = Plan.from_dict(meta["plan"])
        ex = PlanExecutor(plan, self.store, self.registry, device=self.device)
        for channel, payload in ex.run_agent_stream(agg_chunk_groups=1):
            self.conn.send(wire.encode_partial_agg(payload, {
                "msg": "chunk", "req_id": meta.get("req_id"),
                "channel": channel, "seq": 0, "agent": self.name,
                "qtoken": meta.get("qtoken"),
                "attempt": meta.get("attempt"),
            }))
            break
        self.conn.close()  # no exec_done, no exec_error: just gone


class _StallDoneAgent(Agent):
    """Attempt 0 of the target query streams its chunks, then STALLS before
    exec_done (a straggler whose answer is in flight) until the hedged
    duplicate (attempt 1) has answered: the straggler's already-folded
    chunks are the duplicates the merge must discard idempotently.  The
    stall ends on that event, not on a clock, so the hedge has always won
    when attempt 0 reports (the reference's case sleeps a fixed 2.5 s and
    hopes the hedge fires first)."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.stall = False
        self.hedge_answered = threading.Event()

    def _execute(self, meta):
        from pixie_tpu_torch.parallel.partial import PartialAggBatch

        attempt = int(meta.get("attempt") or 0)
        if not self.stall:
            return super()._execute(meta)
        if attempt != 0:
            super()._execute(meta)
            self.hedge_answered.set()
            return None
        plan = Plan.from_dict(meta["plan"])
        ex = PlanExecutor(plan, self.store, self.registry, device=self.device)
        counts = {}
        for channel, payload in ex.run_agent_stream(agg_chunk_groups=0):
            seq = counts.get(channel, 0)
            counts[channel] = seq + 1
            extra = {"msg": "chunk", "req_id": meta.get("req_id"),
                     "channel": channel, "seq": seq, "agent": self.name,
                     "qtoken": meta.get("qtoken"), "attempt": attempt}
            assert isinstance(payload, PartialAggBatch)
            self.conn.send(wire.encode_partial_agg(payload, extra))
        self.hedge_answered.wait(timeout=25.0)
        self.conn.send(wire.encode_json({
            "msg": "exec_done", "req_id": meta.get("req_id"),
            "agent": self.name, "qtoken": meta.get("qtoken"),
            "attempt": attempt, "stats": {}, "chunks": counts,
        }))


def _canon(results):
    return canonical_bytes(results)


# -------------------------------------------------- eviction → re-dispatch


def test_kill_mid_stream_retried_query_bit_equal():
    """An agent dying mid-stream, then restarting under the same name over
    the same store, must yield a BIT-equal answer with zero client-visible
    errors: its partial chunks are discarded (per-source folds), the
    fragment re-dispatches to the new incarnation under a fresh token."""
    flags.set_for_testing("PL_QUERY_RETRIES", 6)
    flags.set_for_testing("PL_RETRY_BACKOFF_MS", 100)
    flags.set_for_testing("PL_CLIENT_RETRIES", 4)
    broker = Broker(hb_expiry_s=5.0, query_timeout_s=30.0).start()
    stores = {"pem1": _mkstore(1), "pem2": _mkstore(2)}
    a1 = Agent("pem1", "127.0.0.1", broker.port, store=stores["pem1"],
               heartbeat_s=0.2).start()
    a2 = _DieOnceAgent("pem2", "127.0.0.1", broker.port,
                       store=stores["pem2"], heartbeat_s=0.2)
    client = Client("127.0.0.1", broker.port, timeout_s=30.0)
    restarted = {}

    def restarter():
        while not a2.died:
            time.sleep(0.01)
        time.sleep(0.15)
        restarted["agent"] = Agent("pem2", "127.0.0.1", broker.port,
                                   store=stores["pem2"],
                                   heartbeat_s=0.2).start()

    try:
        # fault-free baseline from an ordinary agent pair
        tmp = Agent("pem2", "127.0.0.1", broker.port, store=stores["pem2"],
                    heartbeat_s=0.2).start()
        baseline = _canon(client.execute_script(AGG_SCRIPT))
        tmp.stop()
        time.sleep(0.1)
        a2.start()
        threading.Thread(target=restarter, daemon=True).start()
        d0 = metrics.counter_value("px_chunks_discarded_total")
        res = client.execute_script(AGG_SCRIPT)
        assert _canon(res) == baseline  # BIT-equal recovery
        assert res["out"].to_pandas()["cnt"].sum() == 40_000
        # the dead incarnation's partial chunk was discarded, not folded
        assert metrics.counter_value("px_chunks_discarded_total") > d0
        assert metrics.counter_value("px_query_retries_total") >= 1
        assert metrics.counter_value("px_agent_evictions_total") >= 1
    finally:
        client.close()
        a1.stop()
        a2.stop()
        if "agent" in restarted:
            restarted["agent"].stop()
        broker.stop()


def test_retry_budget_exhausted_clean_error_with_retry_after():
    """An agent that dies and NEVER returns: the broker re-tries within its
    budget, then fails with a clean retryable error carrying a retry-after
    hint — not a timeout, not a stack of partial data."""
    flags.set_for_testing("PL_QUERY_RETRIES", 1)
    flags.set_for_testing("PL_RETRY_BACKOFF_MS", 50)
    flags.set_for_testing("PL_REJOIN_GRACE_S", 30.0)  # never re-plans around
    flags.set_for_testing("PL_CLIENT_RETRIES", 0)
    broker = Broker(hb_expiry_s=5.0, query_timeout_s=20.0).start()
    a1 = Agent("pem1", "127.0.0.1", broker.port, store=_mkstore(1),
               heartbeat_s=0.2).start()
    a2 = _DieOnceAgent("pem2", "127.0.0.1", broker.port, store=_mkstore(2),
                       heartbeat_s=0.2).start()
    client = Client("127.0.0.1", broker.port, timeout_s=25.0)
    try:
        t0 = time.monotonic()
        with pytest.raises(QueryError) as ei:
            client.execute_script(AGG_SCRIPT)
        assert time.monotonic() - t0 < 15.0  # clean error, not a timeout
        assert "pem2" in str(ei.value)
        assert ei.value.retryable is True
        assert ei.value.retry_after_s is not None
        assert ei.value.retry_after_s > 0
    finally:
        client.close()
        a1.stop()
        a2.stop()
        broker.stop()


def test_retries_zero_restores_fail_fast():
    """PL_QUERY_RETRIES=0: today's fail-fast contract, message-identical."""
    flags.set_for_testing("PL_QUERY_RETRIES", 0)
    flags.set_for_testing("PL_CLIENT_RETRIES", 0)
    broker = Broker(hb_expiry_s=5.0, query_timeout_s=10.0).start()
    a1 = Agent("pem1", "127.0.0.1", broker.port, store=_mkstore(1),
               heartbeat_s=0.2).start()
    a2 = _DieOnceAgent("pem2", "127.0.0.1", broker.port, store=_mkstore(2),
                       heartbeat_s=0.2).start()
    client = Client("127.0.0.1", broker.port, timeout_s=15.0)
    try:
        with pytest.raises(QueryError) as ei:
            client.execute_script(AGG_SCRIPT)
        assert str(ei.value) == "agent pem2 disconnected mid-query"
    finally:
        client.close()
        a1.stop()
        a2.stop()
        broker.stop()


# ------------------------------------------------------- straggler hedging


def test_straggler_hedge_first_answer_wins_duplicates_discarded():
    flags.set_for_testing("PL_QUERY_RETRIES", 2)
    flags.set_for_testing("PL_HEDGE_ENABLED", True)
    flags.set_for_testing("PL_HEDGE_MIN_MS", 150)
    flags.set_for_testing("PL_HEDGE_FACTOR", 1.0)
    broker = Broker(hb_expiry_s=5.0, query_timeout_s=30.0).start()
    stores = {"pem1": _mkstore(1), "pem2": _mkstore(2)}
    a1 = Agent("pem1", "127.0.0.1", broker.port, store=stores["pem1"],
               heartbeat_s=0.2).start()
    a2 = _StallDoneAgent("pem2", "127.0.0.1", broker.port,
                         store=stores["pem2"], heartbeat_s=0.2).start()
    client = Client("127.0.0.1", broker.port, timeout_s=30.0)
    try:
        # warm the service-time model past HEDGE_MIN_SAMPLES
        for _ in range(9):
            client.execute_script(AGG_SCRIPT)
        baseline = _canon(client.execute_script(AGG_SCRIPT))
        h0 = metrics.counter_value("px_hedged_dispatches_total")
        d0 = metrics.counter_value("px_chunks_discarded_total")
        a2.stall = True  # attempt 0's chunks land, its exec_done waits
        results, stats = broker.execute_script(AGG_SCRIPT)
        assert a2.hedge_answered.is_set()
        assert _canon(results) == baseline  # first answer wins, bit-equal
        assert stats["fault"]["hedged"] >= 1
        assert stats["fault"]["chunks_discarded"] >= 1
        assert metrics.counter_value("px_hedged_dispatches_total") > h0
        assert metrics.counter_value("px_chunks_discarded_total") > d0
    finally:
        a2.stall = False
        a2.hedge_answered.set()
        client.close()
        a1.stop()
        a2.stop()
        broker.stop()


def test_late_duplicate_chunks_never_fold_into_answer():
    """Frames carrying a stale (agent, attempt) token validate against
    their OWN dispatch, fold into a sub-accumulator nobody accepts, and
    the merged answer is exact — idempotent discard, not corruption."""
    flags.set_for_testing("PL_QUERY_RETRIES", 2)
    broker = Broker(hb_expiry_s=5.0, query_timeout_s=15.0).start()
    stores = {"pem1": _mkstore(1), "pem2": _mkstore(2)}
    agents = [Agent(n, "127.0.0.1", broker.port, store=st,
                    heartbeat_s=0.2).start() for n, st in stores.items()]
    try:
        baseline = _canon(broker.execute_script(AGG_SCRIPT)[0])
        # inject a duplicate chunk mid-query by replaying every pem1 chunk
        # frame twice at the transport seam: decode its own chunk, re-fold
        orig = broker._handle_chunk

        def double_fold(conn, meta, payload):
            orig(conn, meta, payload)
            if meta.get("agent") == "pem1" and int(meta.get("seq", 0)) == 0:
                # replay with a WRONG attempt: must be dropped (token
                # mismatch for that src), counted, and never folded
                meta2 = dict(meta)
                meta2["attempt"] = int(meta.get("attempt") or 0) + 7
                orig(conn, meta2, payload)

        broker._handle_chunk = double_fold
        s0 = metrics.counter_value("px_broker_stale_token_frames_total")
        results, _stats = broker.execute_script(AGG_SCRIPT)
        broker._handle_chunk = orig
        assert _canon(results) == baseline
        assert metrics.counter_value(
            "px_broker_stale_token_frames_total") > s0
    finally:
        for a in agents:
            a.stop()
        broker.stop()


# ------------------------------------------------ mutations & client rules


def test_mutation_scripts_never_auto_retried():
    flags.set_for_testing("PL_CLIENT_RETRIES", 5)
    broker = Broker(hb_expiry_s=5.0, query_timeout_s=10.0).start()
    client = Client("127.0.0.1", broker.port, timeout_s=15.0)
    try:
        # no agents at all: a retryable condition for plain scripts, but a
        # mutation must fail immediately (one attempt, no backoff loop)
        t0 = time.monotonic()
        with pytest.raises(QueryError):
            client.execute_script(MUTATION_SCRIPT, func="probe")
        assert time.monotonic() - t0 < 2.0
        assert client.last_retries == 0
    finally:
        client.close()
        broker.stop()


# ------------------------------------------------- incarnation fencing


def test_rejoin_fences_stale_incarnation_frames():
    """A re-registration under the same name supersedes the old socket:
    whatever the old socket still delivers (heartbeats, chunks) is dropped
    and counted, and the new incarnation serves queries normally."""
    flags.set_for_testing("PL_QUERY_RETRIES", 2)
    broker = Broker(hb_expiry_s=5.0, query_timeout_s=15.0).start()
    st = _mkstore(1)
    a_old = Agent("pem1", "127.0.0.1", broker.port, store=st,
                  heartbeat_s=999.0).start()
    # the broker-side socket of the OLD incarnation
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and "pem1" not in broker._agent_conns:
        time.sleep(0.01)
    old_side = broker._agent_conns["pem1"]
    inc0 = broker.registry.incarnation("pem1")
    a_new = Agent("pem1", "127.0.0.1", broker.port, store=st,
                  heartbeat_s=0.2).start()
    try:
        assert broker.registry.incarnation("pem1") == inc0 + 1
        assert old_side.state.get("superseded") is True
        s0 = metrics.counter_value(
            "px_broker_stale_incarnation_frames_total")
        # a frame the old socket's reader had already queued when the
        # supersede landed: the incarnation fence must drop it — a stale
        # heartbeat would keep the dead socket's record warm, a stale
        # chunk would fold ghost data
        broker._on_frame(old_side, wire.encode_json(
            {"msg": "heartbeat", "agent": "pem1"}))
        assert metrics.counter_value(
            "px_broker_stale_incarnation_frames_total") > s0
        # the new incarnation serves (matview/resident state rebuilds via
        # the normal first-sight rescan path)
        res = broker.execute_script(AGG_SCRIPT)[0]
        assert res["out"].to_pandas()["cnt"].sum() == 20_000
    finally:
        a_old.stop()
        a_new.stop()
        broker.stop()


# ------------------------------------------------- fault-injection layer


def test_fault_plan_parse_and_determinism():
    spec = ("seed=42;crash:agent:pem2@send=5;drop:agent:pem1@recv=3;"
            "delay:agent:pem1@send=2:ms=10;slow:agent:*:ms=1:jitter=5")
    runs = []
    for _ in range(2):
        inj = faultinject.FaultInjector(spec)
        for frame in range(1, 8):
            inj.on_frame(1, "agent:pem1", "send")
            inj.on_frame(1, "agent:pem1", "recv")
            inj.on_frame(2, "agent:pem2", "send")
        runs.append(list(inj.log))
    assert runs[0] == runs[1]  # same seed, same frames → same decisions
    assert ("agent:pem2", "send", 5, "crash") in runs[0]
    assert ("agent:pem1", "recv", 3, "drop") in runs[0]
    # the slow rule fires on every pem2... no: label agent:* matches both;
    # delay decisions come back with deterministic jitter
    inj_a = faultinject.FaultInjector(spec)
    inj_b = faultinject.FaultInjector(spec)
    da = inj_a.on_frame(9, "agent:pem1", "send")
    db = inj_b.on_frame(9, "agent:pem1", "send")
    assert da is not None and db is not None
    assert da.delay_s == db.delay_s  # seeded jitter, not wall-clock RNG


def test_fault_plan_rejects_malformed():
    with pytest.raises(InvalidArgument):
        faultinject.parse_plan("explode:agent:pem1@send=1")
    with pytest.raises(InvalidArgument):
        faultinject.parse_plan("crash:agent:pem1")  # no frame
    with pytest.raises(InvalidArgument):
        faultinject.parse_plan("slow:agent:pem1@send=3:ms=5")  # slow+frame


def test_injected_crash_kills_agent_mid_stream_and_recovers():
    """The transport-seam crash: agent pem2's 30th outbound frame (mid
    chunk stream under 1-group agg chunks) kills its socket; with retries
    on and the agent restarting, the query recovers bit-equal."""
    flags.set_for_testing("PL_QUERY_RETRIES", 6)
    flags.set_for_testing("PL_RETRY_BACKOFF_MS", 100)
    flags.set_for_testing("PL_CLIENT_RETRIES", 4)
    flags.set_for_testing("PL_STREAM_AGG_CHUNK_GROUPS", 1)
    broker = Broker(hb_expiry_s=5.0, query_timeout_s=30.0).start()
    stores = {"pem1": _mkstore(1), "pem2": _mkstore(2)}
    agents = {n: Agent(n, "127.0.0.1", broker.port, store=st,
                       heartbeat_s=0.2).start()
              for n, st in stores.items()}
    client = Client("127.0.0.1", broker.port, timeout_s=30.0)
    try:
        baseline = _canon(client.execute_script(AGG_SCRIPT))
        watched = agents["pem2"].conn

        def restarter():
            while not watched.closed:
                time.sleep(0.01)
            time.sleep(0.15)
            agents["pem2"] = Agent("pem2", "127.0.0.1", broker.port,
                                   store=stores["pem2"],
                                   heartbeat_s=0.2).start()

        threading.Thread(target=restarter, daemon=True).start()
        # frame counting starts at install: pem2's 3rd outbound frame from
        # here lands inside the next query's chunk stream (1-group chunks)
        faultinject.install("crash:agent:pem2@send=3")
        res = client.execute_script(AGG_SCRIPT)
        faultinject.uninstall()
        assert _canon(res) == baseline
    finally:
        faultinject.uninstall()
        flags.set_for_testing("PL_STREAM_AGG_CHUNK_GROUPS", 65536)
        client.close()
        for a in agents.values():
            a.stop()
        broker.stop()


# ------------------------------------------- tests/test_durability.py's cases


def test_faultinject_kill_rule_fires_handler_once():
    seed, rules = faultinject.parse_plan("kill:agent:pem1@send=2")
    assert rules[0].action == "kill" and rules[0].frame == 2
    with pytest.raises(Exception):
        faultinject.parse_plan("kill:agent:pem1")  # needs a frame index
    fired = []
    faultinject.register_kill_handler("agent:pem1", lambda: fired.append(1))
    try:
        inj = faultinject.FaultInjector("kill:agent:pem1@send=2")
        assert inj.on_frame(1, "agent:pem1", "send") is None
        d = inj.on_frame(1, "agent:pem1", "send")
        assert d is not None and d.action == "kill"
        assert faultinject.fire_kill("agent:pem1") and fired == [1]
        assert inj.on_frame(2, "agent:pem1", "send") is None
        assert inj.on_frame(2, "agent:pem1", "send") is None
        inj2 = faultinject.FaultInjector("kill:agent:pem1@send=2")
        inj2.on_frame(1, "agent:pem1", "send")
        inj2.on_frame(1, "agent:pem1", "send")
        assert inj2.log == inj.log[:len(inj2.log)]
        assert ("agent:pem1", "send", 2, "kill") in inj2.log
    finally:
        faultinject.unregister_kill_handler("agent:pem1")
    assert not faultinject.fire_kill("agent:pem1")


def test_service_time_model_bounded():
    broker = Broker(hb_expiry_s=30.0)
    try:
        for i in range(Broker.MAX_SVC_AGENTS + 50):
            broker._record_service_time(f"agent-{i:04d}", 0.01)
        assert len(broker._svc) <= Broker.MAX_SVC_AGENTS
        broker._record_service_time("agent-0000", 0.02)
        assert len(broker._svc) <= Broker.MAX_SVC_AGENTS
    finally:
        broker.stop()


# ------------------------------------------------- parity with the reference


FAULT_SPECS = [
    "seed=42;crash:agent:pem2@send=5;drop:agent:pem1@recv=3;"
    "delay:agent:pem1@send=2:ms=10;slow:agent:*:ms=1:jitter=5",
    "seed=7;reset:agent:*@recv=4;kill:agent:pem3@send=2;slow:client:ms=3:jitter=9",
    "drop:agent:pem*@send=1;delay:agent:pem2@recv=6:ms=2",
]


@pytest.mark.parametrize("spec", FAULT_SPECS)
def test_fault_plans_decide_as_the_references(spec):
    """The plan parser and FaultInjector give the reference's rules and
    decisions (action, delay) for the same spec, seed and frames."""
    from pixie_tpu.services import faultinject as ref_fi

    seed, rules = faultinject.parse_plan(spec)
    rseed, rrules = ref_fi.parse_plan(spec)
    assert seed == rseed
    assert [dataclasses.asdict(r) for r in rules] == [dataclasses.asdict(r) for r in rrules]
    frames = [(c, label, d) for _ in range(8)
              for c, label in ((1, "agent:pem1"), (2, "agent:pem2"), (3, "agent:pem3"),
                               (4, "client"))
              for d in ("send", "recv")]
    got, want = faultinject.FaultInjector(spec), ref_fi.FaultInjector(spec)
    for f in frames:
        a, b = got.on_frame(*f), want.on_frame(*f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert (a.action, a.delay_s) == (b.action, b.delay_s), f
    assert got.log == want.log and got.log
