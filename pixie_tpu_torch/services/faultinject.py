"""Deterministic seeded fault injection for the framed-TCP transport.

The reference assumes constant agent churn (k8s nodes die mid-query; PEMs
heartbeat every 5s and the broker runs producer watchdogs).  Reproducing
those failures by actually killing processes makes tests timing-dependent;
this layer instead injects faults AT THE TRANSPORT SEAM, keyed to frame
COUNTS on labeled connections — the same failure surface (a socket that
dies mid-chunk-stream, a dropped ack, a slow producer) but deterministic:
the Nth frame on a connection is the Nth frame on every run.

Plan grammar (`PL_FAULT_PLAN`, rules separated by `;`):

    seed=42                              # jitter RNG seed (default 0)
    crash:agent:pem2@send=5              # close the conn hard before its
                                         #   5th outbound frame
    kill:agent:pem2@send=5               # TRUE pod loss: fire the label's
                                         #   registered kill handler (the
                                         #   agent DROPS its in-memory
                                         #   store) then RST the socket —
                                         #   recovery must come from the
                                         #   journal + replica peers, never
                                         #   from preserved process state
    reset:agent:pem2@recv=3              # RST (SO_LINGER 0) before the 3rd
                                         #   inbound frame is delivered
    drop:agent:pem1@send=2               # swallow one frame silently
    delay:agent:pem1@send=4:ms=250       # sleep before one frame
    slow:agent:*:ms=20:jitter=10         # every outbound frame on matching
                                         #   conns sleeps ms ± U(0,jitter)

Rule shape: `action:LABEL[@send=N|@recv=N|@frame=N][:k=v...]` — LABEL is an
fnmatch pattern over `Connection.label` (agents label their broker dial
`agent:<name>`, clients `client`; unlabeled conns keep their peer-addr
name).  `frame=` is an alias for `send=`.  Frame indices are 1-based and
count per (connection, direction); each frame-indexed rule fires ONCE
globally — it is an event ("crash agent X at frame N"), and a restarted
agent's fresh connection (same label, fresh counter) must not re-crash at
frame N forever.  To kill several connections, write several rules.

Determinism contract (tested): given the same plan string and the same
frame sequence per labeled connection, the injector makes the same
decisions — the slow-rule jitter stream is seeded per (seed, rule, label),
never from wall clock or a shared global RNG.

Copied from the reference package (pixie_tpu/services/faultinject.py).
"""
from __future__ import annotations

import dataclasses
import fnmatch
import random
import threading
import zlib
from typing import Optional

from pixie_tpu_torch import flags
from pixie_tpu_torch.status import InvalidArgument

flags.define_str(
    "PL_FAULT_PLAN", "",
    "deterministic transport fault plan (services/faultinject.py grammar: "
    "crash/reset/drop/delay at frame N, slow with seeded jitter); empty "
    "disables injection entirely")

ACTIONS = ("crash", "reset", "drop", "delay", "slow", "kill")


@dataclasses.dataclass
class Rule:
    action: str  # crash | reset | drop | delay | slow
    label: str  # fnmatch pattern over Connection.label
    direction: str  # "send" | "recv"
    frame: Optional[int]  # 1-based; None = every frame (slow)
    ms: float = 0.0
    jitter_ms: float = 0.0


@dataclasses.dataclass
class Decision:
    """What the transport must do with one frame."""

    action: str  # "crash" | "reset" | "drop" | "delay"
    delay_s: float = 0.0


def parse_plan(spec: str) -> tuple[int, list[Rule]]:
    """`PL_FAULT_PLAN` string → (seed, rules).  Raises InvalidArgument on a
    malformed rule — a typo'd chaos plan must fail the run loudly, not
    silently inject nothing."""
    seed = 0
    rules: list[Rule] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if part.startswith("seed="):
            seed = int(part[5:])
            continue
        action, _, rest = part.partition(":")
        if action not in ACTIONS or not rest:
            raise InvalidArgument(f"fault plan: bad rule {part!r}")
        # trailing :k=v options; the label may itself contain ':'
        segs = rest.split(":")
        opts: dict[str, str] = {}
        while len(segs) > 1 and "=" in segs[-1]:
            k, _, v = segs[-1].partition("=")
            if not k.isidentifier():
                break
            opts[k] = v
            segs.pop()
        label = ":".join(segs)
        direction, frame = "send", None
        if "@" in label:
            label, _, at = label.partition("@")
            d, _, n = at.partition("=")
            if d == "frame":
                d = "send"
            if d not in ("send", "recv") or not n:
                raise InvalidArgument(f"fault plan: bad frame spec {at!r}")
            direction, frame = d, int(n)
        if action == "slow" and frame is not None:
            raise InvalidArgument("fault plan: slow rules apply to every "
                                  "frame (use delay for one frame)")
        if action in ("crash", "reset", "drop", "kill") and frame is None:
            raise InvalidArgument(f"fault plan: {action} needs @send=N/@recv=N")
        if action == "delay" and frame is None:
            raise InvalidArgument("fault plan: delay needs @send=N/@recv=N")
        rules.append(Rule(
            action=action, label=label, direction=direction, frame=frame,
            ms=float(opts.get("ms", 0.0)),
            jitter_ms=float(opts.get("jitter", 0.0)),
        ))
    return seed, rules


class FaultInjector:
    """Evaluates a parsed plan against per-(connection, direction) frame
    counters.  One injector is installed process-wide (`install`); the
    transport consults it per frame only when one is active."""

    def __init__(self, spec: str):
        self.spec = spec
        self.seed, self.rules = parse_plan(spec)
        self._lock = threading.Lock()
        #: (conn id, direction) -> frames seen (labels are not unique —
        #: several conns may share one, each with its own frame sequence)
        self._counts: dict[tuple, int] = {}
        #: rule idx -> fired.  Frame-indexed rules are one-shot EVENTS
        #: ("crash agent X at frame N" happens once): without this, a
        #: restarted agent's fresh connection — same label, fresh frame
        #: counter — would re-crash at frame N forever, turning one
        #: injected kill into a permanent outage
        self._fired: set[int] = set()
        #: (rule idx, label) -> Random for slow-jitter (seeded, not global)
        self._rngs: dict[tuple, random.Random] = {}
        #: decision log for determinism assertions:
        #: (label, direction, frame_idx, action)
        self.log: list[tuple] = []

    def _jitter(self, idx: int, rule: Rule, label: str) -> float:
        if rule.jitter_ms <= 0:
            return 0.0
        key = (idx, label)
        rng = self._rngs.get(key)
        if rng is None:
            # stable across processes: no PYTHONHASHSEED dependence
            rng = self._rngs[key] = random.Random(
                self.seed ^ zlib.crc32(f"{idx}|{label}".encode()))
        return rng.uniform(0, rule.jitter_ms)

    def on_frame(self, conn_id: int, label: str,
                 direction: str) -> Optional[Decision]:
        """Called by the transport before sending / delivering one frame.
        Returns the decision to apply, or None to proceed untouched."""
        with self._lock:
            key = (conn_id, direction)
            idx = self._counts.get(key, 0) + 1
            self._counts[key] = idx
            for i, r in enumerate(self.rules):
                if r.direction != direction or not fnmatch.fnmatchcase(
                        label, r.label):
                    continue
                if r.frame is None:  # slow: every frame pays the latency
                    delay = (r.ms + self._jitter(i, r, label)) / 1e3
                    self.log.append((label, direction, idx, "slow"))
                    return Decision("delay", delay_s=delay)
                if r.frame != idx or i in self._fired:
                    continue
                self._fired.add(i)
                self.log.append((label, direction, idx, r.action))
                if r.action == "delay":
                    return Decision(
                        "delay",
                        delay_s=(r.ms + self._jitter(i, r, label)) / 1e3)
                return Decision(r.action)
        return None


#: the process-wide injector; None (the overwhelmingly common case) keeps
#: the transport's per-frame cost to one attribute load
_active: Optional[FaultInjector] = None
_install_lock = threading.Lock()

#: label → pod-kill handler (agents register their broker-link label).
#: A `kill:` decision fires the handler BEFORE the RST so the store is
#: gone by the time the broker sees the eviction — exactly a pod death's
#: ordering.  Exact-label match: the handler registry is a service-side
#: contract, not a chaos-plan pattern (plans still match by fnmatch).
_kill_handlers: dict[str, object] = {}
_kill_lock = threading.Lock()


def register_kill_handler(label: str, fn) -> None:
    with _kill_lock:
        _kill_handlers[label] = fn


def unregister_kill_handler(label: str, fn=None) -> None:
    """Remove the label's handler.  Pass `fn` to remove ONLY if that exact
    handler is still registered — a stopped old Agent instance must not pop
    the handler its restarted successor registered under the same label."""
    with _kill_lock:
        if fn is None or _kill_handlers.get(label) == fn:
            _kill_handlers.pop(label, None)


def fire_kill(label: str) -> bool:
    """Invoke the kill handler for `label` (transport calls this on a
    `kill` decision).  Returns whether a handler ran; handler errors are
    swallowed — the connection dies regardless, as in a real pod loss."""
    with _kill_lock:
        fn = _kill_handlers.get(label)
    if fn is None:
        return False
    try:
        fn()
    except Exception:
        pass
    return True


def install(spec: Optional[str] = None) -> Optional[FaultInjector]:
    """Arm injection from `spec` (default: the PL_FAULT_PLAN flag).  An
    empty spec disarms.  Returns the active injector (or None)."""
    global _active
    if spec is None:
        spec = str(flags.get("PL_FAULT_PLAN"))
    with _install_lock:
        _active = FaultInjector(spec) if spec.strip() else None
        return _active


def uninstall() -> None:
    global _active
    with _install_lock:
        _active = None


def active() -> Optional[FaultInjector]:
    return _active


# arm from the environment at import: a process started with PL_FAULT_PLAN
# set (the chaos bench's subprocesses, an operator reproducing a failure)
# injects without any code calling install()
if str(flags.get("PL_FAULT_PLAN")).strip():  # pragma: no cover — env-driven
    install()
