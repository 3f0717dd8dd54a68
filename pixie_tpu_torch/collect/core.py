"""Collection runtime — the Stirling core analog.

Reference architecture (src/stirling/stirling.h:52-99, core/):
  * SourceConnector: samples a data source, appends records to DataTables
    (core/source_connector.h:65 TransferData).
  * InfoClassManager/DataTable: table schemas + RecordBuilder append
    (core/data_table.h:32-69).
  * FrequencyManager: per-source sampling/push due-times (core/frequency_manager.h).
  * Stirling::Run: poll loop over due sources, pushing into the table store
    via a registered data-push callback (stirling.cc).

Connectors produce COLUMNAR batches (dict of arrays), not per-row records —
the table store dictionary-encodes at write and seals fixed pow2 batches,
so ingest feeds the executor's fixed-size feeds directly.  The
poll loop runs on a background thread while queries execute concurrently
against snapshot cursors (Table.cursor is snapshot-isolated by design).

Copied from the reference package (pixie_tpu/collect/core.py).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

from pixie_tpu_torch.status import InvalidArgument
from pixie_tpu_torch.table.table import TableStore
from pixie_tpu_torch.types import Relation


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """Schema + cadence of one table a connector publishes (reference
    InfoClassManager: schema + sampling/push periods)."""

    name: str
    relation: Relation
    #: seconds between transfer_data calls for this connector
    sample_period_s: float = 1.0
    #: table store sizing
    max_bytes: int = 256 * 1024 * 1024
    batch_rows: int = 1 << 16


class SourceConnector:
    """Base class (reference core/source_connector.h).

    Lifecycle: init() once → transfer_data() on every due tick → stop().
    transfer_data returns {table_name: {col: array-like}} — empty dict or
    missing tables mean "nothing new this tick".
    """

    name: str = "source"

    def tables(self) -> list[TableSpec]:
        raise NotImplementedError

    def init(self) -> None:  # pragma: no cover - optional hook
        pass

    def transfer_data(self) -> dict[str, dict]:
        raise NotImplementedError

    def stop(self) -> None:  # pragma: no cover - optional hook
        pass

    #: True once the source is exhausted (replay reached EOF); the collector
    #: stops polling it.
    exhausted: bool = False


class FrequencyManager:
    """Earliest-due scheduling across sources (reference
    core/frequency_manager.h)."""

    def __init__(self):
        self._due: dict[str, float] = {}
        self._period: dict[str, float] = {}

    def register(self, name: str, period_s: float, now: float):
        self._period[name] = period_s
        self._due[name] = now

    def unregister(self, name: str):
        self._due.pop(name, None)
        self._period.pop(name, None)

    def due(self, now: float) -> list[str]:
        return [n for n, t in self._due.items() if t <= now]

    def mark_ran(self, name: str, now: float):
        # Schedule from the INTENDED time, not the actual run time, so load
        # does not skew the cadence (reference FrequencyManager::Sample).
        nxt = self._due[name] + self._period[name]
        if nxt <= now:  # fell behind: don't build an unbounded backlog
            nxt = now + self._period[name]
        self._due[name] = nxt

    def next_due(self) -> Optional[float]:
        return min(self._due.values()) if self._due else None


class Collector:
    """The Stirling runtime: connector registry + background poll loop pushing
    columnar batches into a TableStore (reference Stirling::Run, stirling.cc).
    """

    def __init__(self, store: Optional[TableStore] = None):
        self.store = store or TableStore()
        self._connectors: dict[str, SourceConnector] = {}
        self._freq = FrequencyManager()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.stats = {"transfers": 0, "rows_pushed": 0, "errors": 0}
        #: optional data-push callback(table_name, n_rows) — the analog of
        #: Stirling::RegisterDataPushCallback (stirling.h:52); the store write
        #: itself is built in.
        self.on_push: Optional[Callable[[str, int], None]] = None

    # ------------------------------------------------------------- registry
    def register(self, connector: SourceConnector) -> None:
        specs = connector.tables()
        if not specs:
            raise InvalidArgument(f"connector {connector.name!r} publishes no tables")
        with self._lock:  # poll thread iterates these dicts
            if connector.name in self._connectors:
                raise InvalidArgument(
                    f"connector {connector.name!r} already registered"
                )
            for spec in specs:
                if not self.store.has(spec.name):
                    self.store.create(
                        spec.name, spec.relation,
                        max_bytes=spec.max_bytes, batch_rows=spec.batch_rows,
                    )
            connector.init()
            self._connectors[connector.name] = connector
            # One cadence per connector: the fastest of its tables' periods.
            period = min(s.sample_period_s for s in specs)
            self._freq.register(connector.name, period, time.monotonic())

    def remove(self, name: str) -> None:
        with self._lock:
            self._remove_locked(name)

    def _remove_locked(self, name: str) -> None:
        c = self._connectors.pop(name, None)
        if c is not None:
            self._freq.unregister(name)
            c.stop()

    def connectors(self) -> list[str]:
        with self._lock:
            return sorted(self._connectors)

    # ------------------------------------------------------------ transfers
    def _transfer(self, name: str) -> int:
        c = self._connectors.get(name)
        if c is None:
            return 0
        try:
            out = c.transfer_data()
        except Exception:
            self.stats["errors"] += 1
            raise
        rows = 0
        for table_name, cols in (out or {}).items():
            if not cols:
                continue
            n = self.store.table(table_name).write(cols)
            rows += n
            if self.on_push is not None:
                self.on_push(table_name, n)
            if n:
                from pixie_tpu_torch import metrics as _metrics

                _metrics.counter_inc(
                    "px_collector_rows_pushed_total", n,
                    labels={"table": table_name},
                    help_="rows pushed into the table store by connectors",
                )
        self.stats["transfers"] += 1
        self.stats["rows_pushed"] += rows
        return rows

    def transfer_once(self) -> int:
        """Run every connector once, due or not (tests / synchronous use)."""
        rows = 0
        with self._lock:
            for name in list(self._connectors):
                rows += self._transfer(name)
                self._freq.mark_ran(name, time.monotonic())
                if self._connectors[name].exhausted:
                    self._remove_locked(name)
        return rows

    # ------------------------------------------------------------ poll loop
    def _run(self):
        while not self._stop.is_set():
            now = time.monotonic()
            with self._lock:
                for name in self._freq.due(now):
                    if self._stop.is_set():
                        break
                    try:
                        self._transfer(name)
                    except Exception:
                        pass  # connector errors must not kill the loop
                    finally:
                        # Reschedule BEFORE exhaustion-removal so an erroring
                        # connector backs off to its period instead of
                        # re-running every loop iteration.
                        if name in self._freq._due:
                            self._freq.mark_ran(name, now)
                    c = self._connectors.get(name)
                    if c is not None and c.exhausted:
                        self._remove_locked(name)
                nxt = self._freq.next_due()
            if nxt is None:
                if not self._connectors:
                    return  # all sources exhausted
                nxt = time.monotonic() + 0.1
            self._stop.wait(timeout=max(0.0, min(nxt - time.monotonic(), 0.5)))

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="pixie-collector", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        for c in list(self._connectors.values()):
            c.stop()

    def wait_exhausted(self, timeout: float = 60.0) -> bool:
        """Block until every registered source is exhausted (replay use)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._connectors:
                    return True
            time.sleep(0.005)
        return False


def now_ns() -> int:
    return time.time_ns()
