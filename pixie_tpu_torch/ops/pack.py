"""P1: the state packer — a state tree's leaves in one byte buffer.

Reference: pixie_tpu/engine/executor.py `_state_packer` (:912) and
`_PackedState` (:905).  The reference concatenated a state's leaves per
dtype (one device buffer per dtype), so that each dtype read back in one
copy; its host `unpack` rebuilt the tree.  The port packs every leaf into
ONE uint8 buffer at a 16-byte-aligned offset (`Layout`), so that the whole
state reads back in one copy, and the host unpack takes numpy views of the
pulled bytes: the unpacked leaves equal a leaf-by-leaf pull bit for bit.
The reference's rule holds: a state with no more leaves than dtypes is not
packed (`state_packer` returns None and the leaves are pulled as they are),
and the decision is cached per (tree, spec), as `_PACK_CACHE` is.

`pack(leaves, layout)` launches kernel P1 (csrc/pack.cu `px_state_pack`) on
CUDA tensors: one launch for up to P1_CAPACITY leaves, its descriptor table
passed by value in the launch's parameters (no upload).  What a layout
alone decides -- the rows' byte counts and offsets, the split into launches
and each launch's grid -- is computed once per Layout (`P1Plan`, cached on
it); a call checks each leaf against the layout, writes the pointers into
its thread's row buffer and makes one C call a launch.  On CPU tensors it
runs the plain version beside it, `pack_plain` (one torch.cat of the
leaves' bytes and their zero padding).  The choice follows the leaves'
device only; a CUDA tensor never reaches the plain version.

The layout is shared with the device finalize (ops/finalize.py) and the
state merge (ops/merge.py): F2's and F1's output buffers, and M1's merged
state, are laid out and unpacked the same way.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from typing import Optional

import numpy as np
import torch

from pixie_tpu_torch.ops import _build

_P1 = "pack"
ALIGN = 16
#: the leaf dtypes P1 takes, with their numpy dtypes for the host unpack
NUMPY_DTYPES = {torch.int32: np.int32, torch.int64: np.int64, torch.float32: np.float32,
       torch.float64: np.float64}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the most leaves one P1 launch carries (csrc/pack.cu kMaxRows)
P1_CAPACITY = 1024
#: int64 words of a P1 descriptor row: source, byte count, destination
_ROW = 3


def flatten(tree, path=()) -> list:
    """[(path, leaf)] of a state tree (a leaf, or nested dicts of leaves),
    in the dicts' key order."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out.extend(flatten(v, path + (k,)))
        return out
    return [(path, tree)]


def unflatten(paths, leaves):
    """The tree flatten() walked: nested dicts rebuilt from the paths (a
    path () is the whole tree)."""
    root: dict = {}
    for path, leaf in zip(paths, leaves):
        if not path:
            return leaf
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return root


def _align(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


@dataclasses.dataclass(frozen=True)
class Layout:
    """Leaves at 16-byte-aligned offsets of one byte buffer, in order."""

    paths: tuple
    dtypes: tuple
    shapes: tuple
    offsets: tuple
    nbytes: int

    @classmethod
    def of(cls, items) -> "Layout":
        """items: [(path, torch dtype, shape)] in buffer order."""
        paths, dtypes, shapes, offsets = [], [], [], []
        off = 0
        for path, dtype, shape in items:
            paths.append(tuple(path))
            dtypes.append(dtype)
            shapes.append(tuple(int(d) for d in shape))
            offsets.append(off)
            off += _align(leaf_nbytes(dtype, shape))
        return cls(tuple(paths), tuple(dtypes), tuple(shapes), tuple(offsets), off)

    def sizes(self) -> list:
        return [leaf_nbytes(d, s) for d, s in zip(self.dtypes, self.shapes)]

    def views(self, buf: torch.Tensor) -> list:
        """Each leaf as a view of the uint8 buffer `buf` (on any device)."""
        return [buf[o:o + n].view(d).view(s)
                for o, n, d, s in zip(self.offsets, self.sizes(), self.dtypes, self.shapes)]

    def unpack(self, raw: np.ndarray):
        """The pulled bytes (a numpy uint8 array) → the tree of numpy leaves,
        views of `raw`."""
        leaves = [raw[o:o + n].view(NUMPY_DTYPES[d]).reshape(s)
                  for o, n, d, s in zip(self.offsets, self.sizes(), self.dtypes, self.shapes)]
        return unflatten(self.paths, leaves)

    @functools.cached_property
    def p1(self) -> "P1Plan":
        """P1's launch plan for this layout (computed on first use)."""
        return P1Plan.of(self)


def leaf_nbytes(dtype: torch.dtype, shape) -> int:
    n = dtype.itemsize
    for d in shape:
        n *= int(d)
    return n


def worth_packing(spec) -> bool:
    """The reference's rule (`_state_packer` :924-926): a state packs only
    when it has more leaves than dtypes, so that packing reduces the pulled
    leaf count.  spec: [(path, dtype, shape)]."""
    return len(spec) > len({d for _p, d, _s in spec})


_PACK_CACHE: dict = {}
_PACK_LOCK = threading.Lock()


def state_packer(state) -> Optional[Layout]:
    """The layout that packs states shaped like `state`, or None when packing
    cannot reduce the pulled leaf count (`worth_packing`).  Cached per
    (tree, spec)."""
    items = flatten(state)
    spec = tuple((path, leaf.dtype, tuple(leaf.shape)) for path, leaf in items)
    with _PACK_LOCK:
        if spec in _PACK_CACHE:
            return _PACK_CACHE[spec]
    got = Layout.of(spec) if worth_packing(spec) else None
    with _PACK_LOCK:
        if len(_PACK_CACHE) > 128:
            _PACK_CACHE.clear()
        _PACK_CACHE[spec] = got
    return got


@dataclasses.dataclass
class Packed:
    """A state packed on its device: `buf` (uint8) and its layout."""

    buf: torch.Tensor
    layout: Layout

    def unpack(self, raw: np.ndarray):
        return self.layout.unpack(raw)

    def tree(self):
        """The state tree, each leaf a view of `buf`."""
        return unflatten(self.layout.paths, self.layout.views(self.buf))


def pack_state(state):
    """→ Packed (one buffer on the state's device), or the state itself when
    state_packer declines it or a leaf is not a tensor."""
    items = flatten(state)
    if not items or not all(isinstance(leaf, torch.Tensor) for _p, leaf in items):
        return state
    layout = state_packer(state)
    if layout is None:
        return state
    return Packed(pack([leaf for _p, leaf in items], layout), layout)


def pack(leaves: list, layout: Layout) -> torch.Tensor:
    """The leaves (in layout order) → one uint8 buffer of layout.nbytes:
    kernel P1 on CUDA tensors, the plain version on CPU tensors."""
    if len(leaves) != len(layout.paths):
        raise ValueError(f"pack: {len(leaves)} leaves for a layout of {len(layout.paths)}")
    if any(x.is_cuda for x in leaves):
        if not all(x.is_cuda for x in leaves):
            raise ValueError("pack: leaves on the CPU and on a CUDA device")
        return _launch_p1(leaves, layout)
    return pack_plain(leaves, layout)


def pack_plain(leaves: list, layout: Layout) -> torch.Tensor:
    """The plain version of P1: one torch.cat of each leaf's bytes and the
    zeros that pad it to its next offset."""
    pieces = []
    for x, n in zip(leaves, layout.sizes()):
        pieces.append(x.reshape(-1).view(torch.uint8))
        if _align(n) > n:
            pieces.append(torch.zeros(_align(n) - n, dtype=torch.uint8, device=x.device))
    if not pieces:
        return torch.empty(0, dtype=torch.uint8)
    return torch.cat(pieces)


@dataclasses.dataclass(frozen=True, eq=False)
class P1Plan:
    """What packing into one Layout launches, decided once per layout.

    template: [leaves, 3] int64 rows with the byte counts and the buffer
      offsets in place (a call adds the buffer's address to the offsets and
      writes the source pointers);
    launches: (first row, end row, most 16-byte words of a leaf) of each
      launch, at most P1_CAPACITY rows each, in leaf order."""

    paths: tuple
    #: per leaf (dtype, shape, contiguous): what the leaf must be
    sigs: tuple
    template: np.ndarray
    launches: tuple
    local: threading.local = dataclasses.field(default_factory=threading.local,
                                               compare=False, repr=False)

    @classmethod
    def of(cls, layout: Layout) -> "P1Plan":
        for d in layout.dtypes:
            if d not in NUMPY_DTYPES:
                raise TypeError(f"pack: no P1 for dtype {d}")
        sizes = layout.sizes()
        template = np.zeros((len(sizes), _ROW), dtype=np.int64)
        template[:, 1] = sizes
        template[:, 2] = layout.offsets
        words = [(n + ALIGN - 1) // ALIGN for n in sizes]
        launches = tuple((a, min(a + P1_CAPACITY, len(sizes)),
                          max([1, *words[a:a + P1_CAPACITY]]))
                         for a in range(0, len(sizes), P1_CAPACITY))
        sigs = tuple((d, torch.Size(s), True) for d, s in zip(layout.dtypes, layout.shapes))
        return cls(layout.paths, sigs, template, launches)

    def rows(self, leaves: list, base: int, device: int) -> np.ndarray:
        """The calling thread's descriptor rows for `leaves` packed into the
        buffer at address `base`: each leaf checked against the layout
        (dtype, shape, device index, contiguous), its pointer written.  The
        buffer is this thread's own and is rewritten by its next call."""
        rows = getattr(self.local, "rows", None)
        if rows is None:
            rows = self.local.rows = self.template.copy()
        ptrs = []
        for x, sig, path in zip(leaves, self.sigs, self.paths):
            if (x.dtype, x.shape, x.is_contiguous()) != sig or x.get_device() != device:
                raise TypeError(f"pack: leaf {'/'.join(map(str, path))} is not a "
                                f"contiguous {sig[0]} {tuple(sig[1])} tensor on device "
                                f"{device}")
            ptrs.append(x.data_ptr())
        rows[:, 0] = ptrs
        np.add(self.template[:, 2], base, out=rows[:, 2])
        return rows


def _launch_p1(leaves: list, layout: Layout) -> torch.Tensor:
    dev = leaves[0].device
    out = torch.empty(layout.nbytes, dtype=torch.uint8, device=dev)
    if not leaves:
        return out
    plan = layout.p1
    rows = plan.rows(leaves, out.data_ptr(), dev.index)
    fn = _build.function(_P1, "px_state_pack", [_P, _I, _L, _I, _P])
    stream = _build.raw_stream(dev.index)
    addr = rows.ctypes.data
    for a, b, max_words in plan.launches:
        err = fn(addr + a * _ROW * 8, b - a, max_words, dev.index, stream)
        _build.check(_P1, err, "state_pack")
        _build.KERNELS[_P1].count("px_state_pack")
    return out
