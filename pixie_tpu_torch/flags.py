"""Flag system: declared, typed, env-overridable configuration.

Reference: C++ gflags with PL_* env fallbacks
(gflags::Int32FromEnv("PL_TABLE_STORE_DATA_LIMIT_MB", 1280),
src/vizier/services/agent/pem/pem_manager.cc:24-35) and the Go side's
pflag+viper (src/shared/services/service_flags.go).

Usage:
    from pixie_tpu_torch import flags
    FEED_ROWS = flags.define_int("PX_FEED_ROWS", 1 << 24, "feed coalescing")
    ... flags.get("PX_FEED_ROWS") ...
Values resolve env var > default; `flags.dump()` lists everything for
debugging/ops (the --help analog).
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Callable, Optional

from pixie_tpu_torch.status import InvalidArgument


@dataclasses.dataclass
class Flag:
    name: str
    default: object
    parse: Callable
    help: str = ""  # noqa: A003
    value: object = None
    from_env: bool = False
    #: live flags re-read the environment on every get(): the declared,
    #: typed replacement for ad-hoc `os.environ.get` at call sites (wire
    #: compression, SPMD/native kill switches) whose callers toggle the
    #: env per-process at runtime.  Env wins over set_for_testing while
    #: present; the registry still documents/dumps the flag like any other.
    live: bool = False


_registry: dict[str, Flag] = {}
_lock = threading.Lock()


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


def _define(name: str, default, parse, help_: str, live: bool = False):
    with _lock:
        f = _registry.get(name)
        if f is not None:
            if f.default != default:
                raise InvalidArgument(
                    f"flag {name} redefined with different default"
                )
            return f.value
        raw = os.environ.get(name)
        value = parse(raw) if raw is not None else default
        _registry[name] = Flag(name, default, parse, help_, value,
                               raw is not None, live)
        return value


def define_int(name: str, default: int, help_: str = "", live: bool = False) -> int:
    return _define(name, int(default), int, help_, live)


def define_float(name: str, default: float, help_: str = "", live: bool = False) -> float:
    return _define(name, float(default), float, help_, live)


def define_str(name: str, default: str, help_: str = "", live: bool = False) -> str:
    return _define(name, str(default), str, help_, live)


def define_bool(name: str, default: bool, help_: str = "", live: bool = False) -> bool:
    return _define(name, bool(default), _parse_bool, help_, live)


def get(name: str):
    f = _registry.get(name)
    if f is None:
        raise InvalidArgument(f"unknown flag {name!r}")
    if f.live:
        raw = os.environ.get(name)
        if raw is not None:
            return f.parse(raw)
    return f.value


def set_for_testing(name: str, value) -> None:
    """Override in-process (tests/ops tooling)."""
    f = _registry.get(name)
    if f is None:
        raise InvalidArgument(f"unknown flag {name!r}")
    f.value = f.parse(str(value)) if not isinstance(value, type(f.default)) else value


def _effective(f: Flag):
    """The value get() would return — live flags re-consult the env."""
    if f.live:
        raw = os.environ.get(f.name)
        if raw is not None:
            return f.parse(raw)
    return f.value


def dump() -> dict[str, dict]:
    """Every declared flag with value/default/source (ops introspection).
    Live flags report their EFFECTIVE value (env re-read, like get())."""
    with _lock:
        return {
            name: {
                "value": _effective(f),
                "default": f.default,
                "from_env": f.from_env or (f.live
                                           and f.name in os.environ),
                "help": f.help,
            }
            for name, f in sorted(_registry.items())
        }


def env_exports() -> dict[str, str]:
    """Declared flags as a child-process environment fragment: every flag
    whose effective value differs from its default (env override or
    set_for_testing), stringified for re-parse by the child's registry.
    Subprocess harnesses (parallel/shard_bench workers) use this instead of
    forwarding raw os.environ reads — the flag registry stays the single
    config surface on both sides of the fork."""
    out: dict[str, str] = {}
    with _lock:
        for name, f in _registry.items():
            raw = os.environ.get(name) if f.live else None
            if raw is not None:
                out[name] = raw
            elif f.from_env or f.value != f.default:
                v = f.value
                out[name] = str(int(v)) if isinstance(v, bool) else str(v)
    return out


def reset_for_testing(name: Optional[str] = None) -> None:
    with _lock:
        if name is None:
            _registry.clear()
        else:
            _registry.pop(name, None)
