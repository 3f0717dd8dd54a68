"""Append-only value dictionaries.

Variable-length bytes never reach the device: STRING (and UINT128/UPID)
columns are encoded at ingest into dense int32 codes; the code→value mapping
lives here, on the host.  Consequences used throughout the engine:

  * string equality/comparison against a literal = integer compare on codes;
  * arbitrary scalar string UDFs (contains, regex, ...) evaluate host-side over
    the *unique values only*, producing a lookup table (LUT) that the device
    applies to row codes with one gather — O(unique) host work instead of
    O(rows);
  * group-by on a dict-encoded column needs no hashing: the code IS a dense
    group id;
  * cross-table code spaces are reconciled with translation LUTs
    (`translate_to`).

This port takes the numpy route of the reference's dictionary only (no native
C++ index): `np.unique` over the batch, then a Python loop over the unique
values in first-occurrence order, so the same writes give the same codes.
"""
from __future__ import annotations

import threading
from typing import Callable, Iterable, Sequence

import numpy as np


class Dictionary:
    """Maps hashable values <-> dense int32 codes. Append-only; codes are stable.

    Thread model: one writer (ingest) + many readers (queries). Readers snapshot
    `size` and never observe a code >= their snapshot without the value present,
    because values are appended before codes are handed out.
    """

    __slots__ = ("_values", "_index", "_lock")

    def __init__(self, values: Iterable | None = None):
        self._values: list = []
        self._index: dict = {}
        self._lock = threading.Lock()
        if values:
            self.encode(list(values))

    def __len__(self) -> int:
        return len(self._values)

    @property
    def size(self) -> int:
        return len(self._values)

    def value(self, code: int):
        return self._values[code]

    def values(self) -> list:
        return list(self._values)

    def get_code(self, value, default: int = -1) -> int:
        """Code for `value`, or `default` if absent (does NOT insert)."""
        return self._index.get(value, default)

    def code(self, value) -> int:
        """Code for `value`, inserting if absent."""
        c = self._index.get(value)
        if c is None:
            with self._lock:
                c = self._index.get(value)
                if c is None:
                    c = len(self._values)
                    self._values.append(value)
                    self._index[value] = c
        return c

    def encode(self, values: Sequence) -> np.ndarray:
        """Vectorized encode of a batch of values → int32 codes.

        O(rows) inverse mapping plus a Python loop over *unique* values only.
        A numpy 'U' array is uniqued as it stands (a C string sort): it cannot
        hold trailing-NUL values, so its uniques equal those of the object
        conversion.  Anything else (lists, tuples) goes through an object
        array, which keeps trailing NULs intact.
        """
        if isinstance(values, np.ndarray) and values.dtype.kind == "U" \
                and values.ndim == 1:
            arr = values
        else:
            arr = np.asarray(values, dtype=object)
        if arr.size == 0:
            return np.empty(0, dtype=np.int32)
        uniq, first_idx, inverse = np.unique(arr, return_index=True, return_inverse=True)
        uniq_list = uniq.tolist()
        # Insert new values in first-occurrence order so code assignment matches
        # what row-at-a-time `code()` calls would have produced (determinism).
        for j in np.argsort(first_idx):
            self.code(uniq_list[j])
        uniq_codes = np.fromiter(
            (self._index[v] for v in uniq_list), dtype=np.int32, count=len(uniq_list)
        )
        return uniq_codes[inverse].astype(np.int32, copy=False)

    def decode(self, codes: np.ndarray) -> list:
        vals = self._values
        return [vals[c] if 0 <= c < len(vals) else None for c in np.asarray(codes).tolist()]

    def lut(self, fn: Callable, out_dtype, size: int | None = None) -> np.ndarray:
        """Apply host `fn` to every dictionary value; return an array indexed by code.

        This is the engine's scalar-string-UDF evaluation strategy: the device
        applies the result with one gather by code.
        """
        n = self.size if size is None else size
        out = np.empty(n, dtype=out_dtype)
        for i in range(n):
            out[i] = fn(self._values[i])
        return out

    def translate_to(self, other: "Dictionary", insert: bool = True) -> np.ndarray:
        """LUT mapping self's codes → other's codes (for cross-table join/union).

        With insert=True missing values are added to `other`; otherwise they map
        to -1 (treated as null / no-match by kernels).
        """
        n = self.size
        out = np.empty(n, dtype=np.int32)
        for i in range(n):
            v = self._values[i]
            out[i] = other.code(v) if insert else other.get_code(v, -1)
        return out

    def nbytes(self) -> int:
        # Rough accounting for table-store memory budgeting.
        return sum(len(v) if isinstance(v, (str, bytes)) else 16 for v in self._values) + 64 * len(
            self._values
        )
