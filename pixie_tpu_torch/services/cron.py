"""Cron scripts: persisted PxL scripts executed on an interval.

Reference: the query broker's ScriptRunner syncs + executes cron scripts
(script_runner/script_runner.go:47-54) backed by the cron-script store
(metadata controllers/cronscript + cloud cron_script svc).  Scripts typically
carry a px.export(...) OTel sink — that is the retention/plugin export path.

Copied from the reference package (pixie_tpu/services/cron.py): the
persisted CronScriptRunner the broker starts (its scripts live in the
broker's KV under cronscript/), and the Ticker the standing views'
background refresh (matview/maintainer.py `start_refresher`) and the
services' self-metrics fold run on.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

from pixie_tpu_torch.status import InvalidArgument, NotFound


@dataclasses.dataclass
class CronScript:
    name: str
    script: str
    interval_s: float
    func: Optional[str] = None
    func_args: Optional[dict] = None
    enabled: bool = True
    # runtime state (not persisted)
    last_run: float = 0.0
    last_error: str = ""
    run_count: int = 0
    error_count: int = 0


class Ticker:
    """Generic periodic maintenance job on a daemon thread — the cron-runner
    tick discipline without the script registry.  Services hang incremental
    maintainers off it (matview standing-view refresh, future compactors);
    a failing tick is counted, never raised (maintenance must not kill its
    host service)."""

    def __init__(self, name: str, interval_s: float, fn: Callable):
        if interval_s <= 0:
            raise InvalidArgument("ticker interval must be positive")
        self.name = name
        self.interval_s = float(interval_s)
        self._fn = fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.tick_count = 0
        self.error_count = 0

    def start(self) -> "Ticker":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(timeout=self.interval_s):
                try:
                    self._fn()
                    self.tick_count += 1
                except Exception:
                    self.error_count += 1
                    from pixie_tpu_torch import metrics as _metrics

                    _metrics.counter_inc(
                        "px_ticker_errors_total",
                        labels={"ticker": self.name},
                        help_="background ticker callbacks that raised "
                              "(the loop continues)")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"pixie-ticker-{self.name}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


class CronScriptRunner:
    """Background executor over a persisted script set."""

    def __init__(self, execute: Callable, kv=None,
                 on_result: Optional[Callable] = None):
        """execute(script, func, func_args) → results (broker.execute_script);
        on_result(name, results) optional hook (tests, custom retention)."""
        self._execute = execute
        self.kv = kv
        self.on_result = on_result
        self._scripts: dict[str, CronScript] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if kv is not None:
            import json

            for _k, raw in kv.scan("cronscript/"):
                d = json.loads(raw.decode())
                cs = CronScript(**{k: d[k] for k in
                                   ("name", "script", "interval_s", "func",
                                    "func_args", "enabled") if k in d})
                self._scripts[cs.name] = cs

    # ---------------------------------------------------------------- registry
    def upsert(self, name: str, script: str, interval_s: float,
               func: Optional[str] = None, func_args: Optional[dict] = None,
               enabled: bool = True) -> CronScript:
        if interval_s <= 0:
            raise InvalidArgument("cron interval must be positive")
        with self._lock:
            cs = CronScript(name, script, float(interval_s), func, func_args, enabled)
            prev = self._scripts.get(name)
            if prev is not None:
                cs.last_run = prev.last_run
                cs.run_count = prev.run_count
                cs.error_count = prev.error_count
            self._scripts[name] = cs
            self._persist(cs)
            return cs

    def delete(self, name: str) -> None:
        with self._lock:
            if name not in self._scripts:
                raise NotFound(f"no cron script {name!r}")
            del self._scripts[name]
            if self.kv is not None:
                self.kv.delete(f"cronscript/{name}")

    def list(self) -> list[CronScript]:  # noqa: A003
        with self._lock:
            return sorted(self._scripts.values(), key=lambda c: c.name)

    def _persist(self, cs: CronScript) -> None:
        if self.kv is not None:
            self.kv.set_json(f"cronscript/{cs.name}", {
                "name": cs.name, "script": cs.script,
                "interval_s": cs.interval_s, "func": cs.func,
                "func_args": cs.func_args, "enabled": cs.enabled,
            })

    # --------------------------------------------------------------- execution
    def run_due(self, now: Optional[float] = None) -> int:
        """Run every enabled script whose interval elapsed; returns #ran."""
        now = time.monotonic() if now is None else now
        with self._lock:
            due = []
            for cs in self._scripts.values():
                if cs.enabled and now - cs.last_run >= cs.interval_s:
                    cs.last_run = now  # claim under the lock
                    due.append(cs)
        ran = 0
        for cs in due:
            try:
                results = self._execute(cs.script, cs.func, cs.func_args)
                err = ""
                if self.on_result is not None:
                    self.on_result(cs.name, results)
            except Exception as e:
                err = str(e)
                from pixie_tpu_torch import metrics as _metrics

                _metrics.counter_inc(
                    "px_cron_script_errors_total",
                    labels={"script": cs.name},
                    help_="cron script executions that raised (recorded on "
                          "the script's error_count/last_error)")
            # Record outcome on whatever object is CURRENTLY registered under
            # this name — an upsert mid-run replaces the object and would
            # otherwise lose the counters.
            with self._lock:
                target = self._scripts.get(cs.name, cs)
                if err:
                    target.error_count += 1
                    target.last_error = err
                else:
                    target.run_count += 1
                    target.last_error = ""
            ran += 1
        return ran

    def start(self, tick_s: float = 1.0) -> "CronScriptRunner":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(timeout=tick_s):
                self.run_due()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="pixie-cron-runner")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
