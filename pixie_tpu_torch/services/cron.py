"""The cron runner's tick: a periodic maintenance job on a daemon thread.

Reference: the query broker's ScriptRunner ticks cron scripts
(script_runner/script_runner.go:47-54).  Copied from the reference package
(pixie_tpu/services/cron.py), its Ticker alone: the standing views'
background refresh (matview/maintainer.py `start_refresher`) runs on it.
The persisted cron-script runner comes with the broker (ROADMAP Queue 1
item 6d), its only caller.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

from pixie_tpu_torch.status import InvalidArgument


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
