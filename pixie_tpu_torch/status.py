"""Error model.

The reference threads `Status`/`StatusOr` through every layer
(src/common/base/status.h).  In Python, exceptions are idiomatic; we keep a small
typed-exception hierarchy plus a Status value object for RPC-style boundaries
(result streams report terminal status like carnotpb's TransferResultChunk does).
"""
from __future__ import annotations

import dataclasses
import enum
import traceback


class Code(enum.IntEnum):
    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    INTERNAL = 13
    UNAVAILABLE = 14
    UNIMPLEMENTED = 12
    RESOURCE_UNAVAILABLE = 15
    COMPILER_ERROR = 100


@dataclasses.dataclass(frozen=True)
class Status:
    code: Code = Code.OK
    msg: str = ""

    @staticmethod
    def ok() -> "Status":
        return Status(Code.OK, "")

    def ok_p(self) -> bool:
        return self.code == Code.OK

    @staticmethod
    def from_exception(e: BaseException) -> "Status":
        if isinstance(e, PxError):
            return Status(e.code, str(e))
        return Status(Code.INTERNAL, "".join(traceback.format_exception_only(e)).strip())


class PxError(Exception):
    """Base error for the framework."""

    code = Code.UNKNOWN


class InvalidArgument(PxError):
    code = Code.INVALID_ARGUMENT


class NotFound(PxError):
    code = Code.NOT_FOUND


class Internal(PxError):
    code = Code.INTERNAL


class Unimplemented(PxError):
    code = Code.UNIMPLEMENTED


class Unavailable(PxError):
    """A required peer (agent/broker) is down or timed out."""

    code = Code.UNAVAILABLE


class CompilerError(PxError):
    """PxL compile error with line context (reference: planner ir::CompilerError)."""

    code = Code.COMPILER_ERROR

    def __init__(self, msg: str, line: int | None = None, col: int | None = None):
        self.line, self.col = line, col
        loc = f" (line {line})" if line is not None else ""
        super().__init__(f"{msg}{loc}")
