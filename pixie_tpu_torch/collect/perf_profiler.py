"""Always-on sampling profiler connector → stack_traces.beta.

Reference: src/stirling/source_connectors/perf_profiler/ — BPF stack sampling
into a dual-buffer table of folded stacks + counts, symbolized and shipped as
the `stack_traces.beta` table feeding px/perf_flamegraph.

Host-runtime redesign: the profiled substrate here is the agent PROCESS
itself (query engine, collectors, services) — sampling walks every Python
thread's frame stack (sys._current_frames) on a background thread at
`hz`, folds frames into "mod.fn;mod.fn;..." strings, and counts per stack.
transfer_data() drains the accumulated counts as rows, exactly the
reference's sample-continuously / push-periodically split
(perf_profile_connector.h:48 dual-buffer swap).

Copied from the reference package (pixie_tpu/collect/perf_profiler.py).
"""
from __future__ import annotations

import sys
import threading
import time
from collections import Counter

from pixie_tpu_torch.collect.core import SourceConnector, TableSpec, now_ns
from pixie_tpu_torch.types import DataType as DT, Relation, UInt128


def fold_stack(frame, max_depth: int = 64) -> str:
    """Frame chain → root-first 'module.func;module.func' folded string
    (the flamegraph input format the reference's stringifier produces)."""
    parts = []
    f = frame
    while f is not None and len(parts) < max_depth:
        code = f.f_code
        mod = f.f_globals.get("__name__", "?")
        parts.append(f"{mod}.{code.co_name}")
        f = f.f_back
    return ";".join(reversed(parts))


class PerfProfilerConnector(SourceConnector):
    """Samples this process's threads; publishes stack_traces.beta."""

    name = "perf_profiler"

    def __init__(self, hz: float = 99.0, push_period_s: float = 5.0,
                 asid: int = 0, pid: int | None = None):
        self.hz = hz
        self.push_period_s = push_period_s
        import os

        from pixie_tpu_torch.metadata.proc_scanner import pid_start_time_ns

        rpid = pid if pid is not None else os.getpid()
        # /proc-derived start time, NOT time.time_ns(): the UPID must equal
        # the one the ProcScanner binds in the metadata state, or ctx['pod']
        # never joins profiler rows
        self._upid = UInt128.make_upid(
            asid, rpid, pid_start_time_ns(rpid) or time.time_ns())
        self._counts: Counter[str] = Counter()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._stack_ids: dict[str, int] = {}
        self.samples_taken = 0
        #: lazily-built native symbolizer (obj_tools): resolves raw return
        #: addresses from externally-captured native stacks (perf-script
        #: replay, ptrace samplers) against /proc/<pid>/maps + ELF symtabs —
        #: the reference's symbolizer stage (perf_profiler/symbolizers/).
        self._native_sym = None

    # ------------------------------------------------------ native frames
    def _symbolizer(self):
        if self._native_sym is None:
            from pixie_tpu_torch.obj_tools import NativeSymbolizer

            self._native_sym = NativeSymbolizer(self._upid.pid)
        return self._native_sym

    def fold_native_stack(self, addrs: list[int]) -> str:
        """Raw leaf-first return addresses → root-first folded symbol string
        (same format as the Python sampler's fold_stack)."""
        sym = self._symbolizer()
        return ";".join(sym.symbolize(a) for a in reversed(addrs))

    def add_native_sample(self, addrs: list[int], count: int = 1) -> None:
        """Ingest one externally-captured native stack (leaf-first raw
        addresses); symbolized + merged into the same folded-count table the
        Python sampler fills."""
        folded = self.fold_native_stack(addrs)
        with self._lock:
            self._counts[folded] += count

    def tables(self) -> list[TableSpec]:
        # reference stack_traces_table.h:31
        return [TableSpec(
            "stack_traces.beta",
            Relation.of(
                ("time_", DT.TIME64NS),
                ("upid", DT.UINT128),
                ("stack_trace_id", DT.INT64),
                ("stack_trace", DT.STRING),
                ("count", DT.INT64),
            ),
            sample_period_s=self.push_period_s,
        )]

    # ----------------------------------------------------------- sampling
    def _sample_loop(self):
        period = 1.0 / self.hz
        me = threading.get_ident()
        while not self._stop.wait(timeout=period):
            frames = sys._current_frames()
            folded = [
                fold_stack(f) for tid, f in frames.items() if tid != me
            ]
            with self._lock:
                for s in folded:
                    if s:
                        self._counts[s] += 1
                self.samples_taken += 1

    def init(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._sample_loop, daemon=True, name="pixie-profiler"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    # ------------------------------------------------------------ transfer
    def transfer_data(self) -> dict[str, dict]:
        with self._lock:
            counts, self._counts = self._counts, Counter()
        if not counts:
            return {}
        t = now_ns()
        stacks = sorted(counts)
        ids = [self._stack_ids.setdefault(s, len(self._stack_ids)) for s in stacks]
        return {"stack_traces.beta": {
            "time_": [t] * len(stacks),
            "upid": [self._upid] * len(stacks),
            "stack_trace_id": ids,
            "stack_trace": stacks,
            "count": [int(counts[s]) for s in stacks],
        }}
