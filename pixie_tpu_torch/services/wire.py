"""Versioned binary wire format for control + data messages.

Replaces the reference's protobuf RowBatchData / TransferResultChunk
(src/carnot/carnotpb/carnot.proto:30-96, vizierpb RowBatchData) with a
self-describing frame:

    MAGIC "PXW1" | u32 header_len | header JSON (utf-8) | buffer bytes...

The header carries the message kind, JSON-safe metadata, and a buffer table
(name, numpy dtype str, length); numeric column data travels as raw
little-endian buffers, NEVER as pickled objects — a malicious peer can at
worst produce wrong values, not code execution (the round-1 advisor flagged
pickle here; this is the replacement).

String payloads (dictionary value lists, object-array string keys) ship as
length-prefixed raw UTF-8: one `|u1` bytes buffer plus an `<i8` offsets
buffer (n+1 entries), NOT as JSON lists — JSON escaping dominated frame
encode time for large string dictionaries.  Non-string values (UINT128
tuples, None) fall back to the JSON `jsonvals` path.

Optional payload compaction (`PL_WIRE_COMPRESS`): when set, the buffer
section of a frame whose raw size exceeds the threshold is compressed as one
blob and announced in the header (`comp`).  Accepted values: `zlib`,
`zlib:<threshold_bytes>`, `lz4[:<threshold>]` (falls back to zlib when the
lz4 module is absent), empty/`0`/`off` = disabled.  The decoder honors
whatever the header announces regardless of the local setting, with a
MAX_FRAME guard on the announced raw size (no zip bombs).

Kinds (copied from the reference package, pixie_tpu/services/wire.py, and
byte for byte its frames):
  json         — control messages ({} metadata only)
  host_batch   — HostBatch: dtypes, dictionaries, columns (the journal's and
                 the cold tier's record payload)
  partial_agg  — PartialAggBatch: key values + flattened UDA state leaves
                 (LocalCluster round-trips every partial through it)
"""
from __future__ import annotations

import json
import struct
import zlib

import numpy as np

from pixie_tpu_torch import flags as _flags
from pixie_tpu_torch.status import InvalidArgument
from pixie_tpu_torch.table.dictionary import Dictionary
from pixie_tpu_torch.types import STORAGE_DTYPE, DataType as DT

_flags.define_str(
    "PL_WIRE_COMPRESS", "",
    "wire payload compaction: zlib[:<threshold>] | lz4[:<threshold>] | "
    "off.  Live: re-read per frame so tests/operators can toggle "
    "per-process", live=True)

MAGIC = b"PXW1"
_HDR = struct.Struct("<4sI")

#: frames larger than this are rejected on decode (also bounds the announced
#: decompressed size of a compressed payload)
MAX_WIRE_BYTES = 1 << 30

#: numpy dtype allowlist for wire buffers (validated on decode).
_ALLOWED_DTYPES = {
    "<i4", "<i8", "<u4", "<u8", "<f4", "<f8", "|b1", "<i2", "<u2", "|i1", "|u1"
}

#: default compression threshold: small frames gain nothing and pay latency
DEFAULT_COMPRESS_THRESHOLD = 1 << 16


def _norm_dtype(d: np.dtype) -> str:
    s = np.dtype(d).str
    if s == "=i8":
        s = "<i8"
    return s


# --------------------------------------------------------------- compression


def _compress_cfg() -> tuple[str, int] | None:
    """(codec, threshold) from PL_WIRE_COMPRESS, or None when disabled.

    A LIVE flag: re-read on every frame (not latched at import) — tests
    and operators toggle it per-process, and the parse is nanoseconds.
    """
    raw = str(_flags.get("PL_WIRE_COMPRESS")).strip().lower()
    if not raw or raw in ("0", "off", "false", "no"):
        return None
    codec, _, thr = raw.partition(":")
    if codec in ("1", "true", "yes", "on"):
        codec = "zlib"
    try:
        threshold = int(thr) if thr else DEFAULT_COMPRESS_THRESHOLD
    except ValueError:
        threshold = DEFAULT_COMPRESS_THRESHOLD
    if codec == "lz4" and _lz4() is None:
        codec = "zlib"
    if codec not in ("zlib", "lz4"):
        codec = "zlib"
    return codec, threshold


def _lz4():
    try:
        import lz4.frame as lz4f  # optional; the container may not ship it

        return lz4f
    except Exception:
        return None


def _compress(codec: str, raw: bytes) -> bytes:
    if codec == "lz4":
        lz4f = _lz4()
        if lz4f is not None:
            return lz4f.compress(raw)
    return zlib.compress(raw, 1)  # level 1: this is a transport, not an archive


def _decompress(codec: str, blob, raw_len: int) -> bytes:
    # Allocation is bounded BEFORE expansion, not checked after: the
    # announced size gates the limit, and the codecs run with max_length so
    # a bomb announcing a small `raw` stops at raw_len+1 produced bytes
    # instead of materializing its full expansion first.
    # raw_len <= 0 is never produced by the encoder (empty buffer sections
    # don't compress) and max_length=0 means UNLIMITED to zlib — rejecting
    # it here is what keeps the bound real.
    if raw_len <= 0 or raw_len > MAX_WIRE_BYTES:
        raise InvalidArgument(
            f"wire: announced decompressed size {raw_len} out of bounds")
    if codec == "zlib":
        d = zlib.decompressobj()
        out = d.decompress(blob, raw_len)
        if len(out) != raw_len or (
                d.unconsumed_tail and d.decompress(d.unconsumed_tail, 1)):
            raise InvalidArgument("wire: decompressed size mismatch")
    elif codec == "lz4":
        lz4f = _lz4()
        if lz4f is None:
            raise InvalidArgument("wire: lz4 frame received but lz4 unavailable")
        d = lz4f.LZ4FrameDecompressor()
        out = d.decompress(bytes(blob), max_length=raw_len)
        if len(out) != raw_len or d.decompress(b"", 1):
            raise InvalidArgument("wire: decompressed size mismatch")
    else:
        raise InvalidArgument(f"wire: unknown compression codec {codec!r}")
    return out


# ------------------------------------------------------------------- encoding


def _frame(kind: str, meta: dict, bufs: list[tuple[str, np.ndarray]]) -> bytes:
    table = []
    chunks = []
    total = 0
    for name, arr in bufs:
        arr = np.ascontiguousarray(arr)
        s = _norm_dtype(arr.dtype)
        if s not in _ALLOWED_DTYPES:
            raise InvalidArgument(f"wire: dtype {s} of buffer {name!r} not allowed")
        # Zero-copy column handoff: a read-only memoryview over the array's
        # own bytes (tobytes() would materialize an intermediate copy of
        # every result column per query); the single copy happens once, in
        # the final join that builds the frame.  Empty arrays can't cast
        # (zeros in shape/strides) — their tobytes() is free anyway.
        raw = memoryview(arr).cast("B") if arr.size else arr.tobytes()
        table.append({"name": name, "dtype": s, "shape": list(arr.shape),
                      "nbytes": len(raw)})
        chunks.append(raw)
        total += len(raw)
    hdr: dict = {"kind": kind, "meta": meta, "bufs": table}
    cfg = _compress_cfg()
    if cfg is not None and total >= cfg[1] and chunks:
        codec, _thr = cfg
        raw = b"".join(chunks)
        blob = _compress(codec, raw)
        if len(blob) < len(raw):  # incompressible payloads ship raw
            hdr["comp"] = {"codec": codec, "raw": len(raw)}
            chunks = [blob]
            from pixie_tpu_torch import metrics as _metrics

            _metrics.counter_inc(
                "px_wire_compressed_frames_total",
                help_="wire frames whose buffer section was compressed")
            _metrics.counter_inc(
                "px_wire_compressed_bytes_saved_total",
                float(len(raw) - len(blob)),
                help_="buffer bytes saved by wire compression")
    header = json.dumps(hdr).encode()
    return b"".join([_HDR.pack(MAGIC, len(header)), header, *chunks])


def encode_json(meta: dict) -> bytes:
    return _frame("json", meta, [])


def encode_error(req_id, error, retry_after_s=None, retryable=None) -> bytes:
    """The error envelope, optionally carrying an admission-control
    retry-after hint (seconds) and/or a retryable marker.  Clients surface
    `retry_after_s` so a shed query backs off instead of hammering a
    saturated broker; `retryable=True` marks an INFRASTRUCTURE failure of
    an idempotent (non-mutation) query — agent eviction with the retry
    budget exhausted, no live agents — that a client may transparently
    re-issue.  Compile/exec errors never set it: retrying won't fix them."""
    meta = {"msg": "error", "req_id": req_id, "error": str(error)}
    if retry_after_s is not None:
        meta["retry_after_s"] = round(float(retry_after_s), 3)
    if retryable is not None:
        meta["retryable"] = bool(retryable)
    return _frame("json", meta, [])


def encode_json_raw(meta: dict, raw_fields: dict[str, str]) -> bytes:
    """encode_json with PRE-SERIALIZED JSON values spliced in as extra
    top-level meta keys.

    The broker's warm-query dispatch caches each agent plan's JSON once per
    compiled split; re-running json.dumps over the whole plan dict on every
    query was measurable interactive latency.  The decoder is unchanged —
    the spliced frame is byte-for-byte a normal json frame.
    """
    for k in raw_fields:
        if k in meta:
            raise InvalidArgument(f"wire: raw field {k!r} collides with meta")
    meta_json = json.dumps(meta)
    items = ",".join(f"{json.dumps(k)}:{v}" for k, v in raw_fields.items())
    if items:
        merged = (f"{{{items}}}" if meta_json == "{}"
                  else f"{meta_json[:-1]},{items}}}")
    else:
        merged = meta_json
    header = (f'{{"kind":"json","meta":{merged},"bufs":[]}}').encode()
    return b"".join([_HDR.pack(MAGIC, len(header)), header])


def _u128_jsonable(v):
    from pixie_tpu_torch.types import UInt128

    if v is None:
        return None
    if isinstance(v, UInt128):
        return [v.high, v.low]
    return list(v)


def _strbuf_encode(vals: list) -> tuple[np.ndarray, np.ndarray] | None:
    """Length-prefixed UTF-8 packing of a pure-string list: (bytes |u1,
    offsets <i8 of n+1 entries).  None when any value is not a str (the
    caller falls back to jsonvals)."""
    enc = []
    for v in vals:
        if type(v) is not str:
            return None
        enc.append(v.encode())
    offs = np.zeros(len(enc) + 1, dtype=np.int64)
    if enc:
        np.cumsum([len(b) for b in enc], out=offs[1:])
    data = np.frombuffer(b"".join(enc), dtype=np.uint8)
    return data, offs


def _strbuf_decode(data: np.ndarray, offs: np.ndarray) -> list:
    if offs.ndim != 1 or len(offs) == 0:
        raise InvalidArgument("wire: bad string offsets buffer")
    blob = data.tobytes()
    ends = offs.tolist()
    if ends[0] != 0 or ends[-1] != len(blob) or any(
            a > b for a, b in zip(ends, ends[1:])):
        raise InvalidArgument("wire: string offsets out of bounds")
    return [blob[a:b].decode() for a, b in zip(ends, ends[1:])]


def _dict_values_jsonable(d: Dictionary, dt: DT) -> list:
    if dt == DT.UINT128:
        return [_u128_jsonable(v) for v in d.values()]
    return d.values()


def _dict_values_restore(vals: list, dt: DT) -> list:
    if dt == DT.UINT128:
        from pixie_tpu_torch.types import UInt128

        # canonical in-memory form is UInt128 (metadata UDFs read .high/.pid)
        return [UInt128(*v) if v is not None else None for v in vals]
    return vals


def encode_host_batch(hb, extra_meta: dict | None = None) -> bytes:
    """HostBatch → frame (reference: RowBatchData on the result stream)."""
    dicts_meta: dict = {}
    bufs: list[tuple[str, np.ndarray]] = []
    for n, d in hb.dicts.items():
        packed = (_strbuf_encode(d.values())
                  if hb.dtypes[n] == DT.STRING else None)
        if packed is not None:
            data, offs = packed
            dicts_meta[n] = {"strbuf": True}
            bufs.append((f"d:{n}", data))
            bufs.append((f"do:{n}", offs))
        else:
            dicts_meta[n] = {"jsonvals": _dict_values_jsonable(d, hb.dtypes[n])}
    meta = {
        "dtypes": {n: int(t) for n, t in hb.dtypes.items()},
        "dicts": dicts_meta,
        "order": list(hb.cols),
    }
    if extra_meta:
        meta.update(extra_meta)
    return _frame("host_batch", meta, bufs + [(n, hb.cols[n]) for n in hb.cols])


def encode_partial_agg(pb, extra_meta: dict | None = None) -> bytes:
    """PartialAggBatch → frame (reference: serialized-UDA partial rows,
    planpb/plan.proto:250-257)."""
    key_meta = {}
    bufs: list[tuple[str, np.ndarray]] = []
    for name, vals in pb.key_cols.items():
        dt = pb.key_dtypes[name]
        arr = np.asarray(vals)
        if arr.dtype == object:
            if dt == DT.UINT128:
                key_meta[name] = {
                    "jsonvals": [_u128_jsonable(v) for v in arr.tolist()]
                }
            else:
                packed = _strbuf_encode(arr.tolist())
                if packed is not None:
                    data, offs = packed
                    key_meta[name] = {"strbuf": True}
                    bufs.append((f"kd:{name}", data))
                    bufs.append((f"ko:{name}", offs))
                else:
                    key_meta[name] = {"jsonvals": arr.tolist()}
        else:
            key_meta[name] = {"buf": f"k:{name}"}
            bufs.append((f"k:{name}", arr))
    states_meta = {}
    for out_name, tree in pb.states.items():
        paths = []
        for path, leaf in _flatten(tree):
            bname = f"s:{out_name}:{path}"
            bufs.append((bname, np.asarray(leaf)))
            paths.append(path)
        states_meta[out_name] = paths
    meta = {
        "key_dtypes": {k: int(v) for k, v in pb.key_dtypes.items()},
        "in_types": {k: (int(v) if v is not None else None) for k, v in pb.in_types.items()},
        "keys": key_meta,
        "states": states_meta,
        "key_order": list(pb.key_cols),
    }
    if extra_meta:
        meta.update(extra_meta)
    return _frame("partial_agg", meta, bufs)


def _flatten(tree, prefix="") -> list[tuple[str, np.ndarray]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            if not isinstance(k, str) or "/" in k:
                raise InvalidArgument(f"wire: bad state key {k!r}")
            p = f"{prefix}/{k}" if prefix else k
            out.extend(_flatten(tree[k], p))
        return out
    return [(prefix, tree)]


def _unflatten(paths: dict[str, np.ndarray]):
    if list(paths) == [""]:
        return paths[""]
    root: dict = {}
    for path, leaf in paths.items():
        parts = path.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = leaf
    return root


# ------------------------------------------------------------------- decoding


def _strbuf_lookup(bufs: dict, data_name: str, offs_name: str) -> list:
    if data_name not in bufs or offs_name not in bufs:
        raise InvalidArgument(f"wire: missing string buffers for {data_name!r}")
    data, offs = bufs[data_name], bufs[offs_name]
    if _norm_dtype(data.dtype) != "|u1" or _norm_dtype(offs.dtype) != "<i8":
        raise InvalidArgument("wire: bad string buffer dtypes")
    return _strbuf_decode(data.reshape(-1), offs.reshape(-1))


def decode_frame(data: bytes):
    """bytes → (kind, payload).

    json        → (kind, meta dict)
    host_batch  → (kind, HostBatch-with-meta)
    partial_agg → (kind, PartialAggBatch-with-meta)
    The original meta dict is attached as `.wire_meta` on decoded objects.
    """
    if len(data) < _HDR.size:
        raise InvalidArgument("wire: truncated frame")
    magic, hlen = _HDR.unpack_from(data)
    if magic != MAGIC:
        raise InvalidArgument(f"wire: bad magic {magic!r}")
    if _HDR.size + hlen > len(data):
        raise InvalidArgument("wire: truncated header")
    header = json.loads(data[_HDR.size : _HDR.size + hlen].decode())
    kind = header["kind"]
    meta = header["meta"]
    # memoryview: the buffer section of a large result frame must not be
    # copied wholesale just to re-slice it per column
    body = memoryview(data)[_HDR.size + hlen:]
    comp = header.get("comp")
    if comp:
        body = _decompress(str(comp.get("codec")), body, int(comp.get("raw", -1)))
    bufs: dict[str, np.ndarray] = {}
    off = 0
    for b in header["bufs"]:
        s = b["dtype"]
        if s not in _ALLOWED_DTYPES:
            raise InvalidArgument(f"wire: dtype {s} not allowed")
        nb = int(b["nbytes"])
        if off + nb > len(body):
            raise InvalidArgument("wire: truncated buffer")
        arr = np.frombuffer(body[off : off + nb], dtype=np.dtype(s))
        # Checked-Python-int product: np.prod would wrap in int64 on an
        # adversarial shape like [2**40, 2**40] and falsely pass.
        import math

        shape = tuple(int(x) for x in b["shape"])
        if any(d < 0 for d in shape) or math.prod(shape) * arr.itemsize != nb:
            raise InvalidArgument("wire: buffer shape/nbytes mismatch")
        bufs[b["name"]] = arr.reshape(shape).copy()  # writable, owned
        off += nb

    if kind == "json":
        return kind, meta
    if kind == "host_batch":
        from pixie_tpu_torch.engine.executor import HostBatch

        dtypes = {n: DT(v) for n, v in meta["dtypes"].items()}
        dicts = {}
        for n, spec in meta["dicts"].items():
            if isinstance(spec, dict) and spec.get("strbuf"):
                dicts[n] = Dictionary(_strbuf_lookup(bufs, f"d:{n}", f"do:{n}"))
            else:
                vals = spec["jsonvals"] if isinstance(spec, dict) else spec
                dicts[n] = Dictionary(_dict_values_restore(vals, dtypes[n]))
        cols = {}
        for n in meta["order"]:
            if n not in bufs:
                raise InvalidArgument(f"wire: missing column buffer {n!r}")
            want = STORAGE_DTYPE[dtypes[n]]
            cols[n] = bufs[n].astype(want, copy=False)
        hb = HostBatch(dtypes, dicts, cols)
        hb.wire_meta = meta  # type: ignore[attr-defined]
        return kind, hb
    if kind == "partial_agg":
        from pixie_tpu_torch.parallel.partial import PartialAggBatch

        key_dtypes = {k: DT(v) for k, v in meta["key_dtypes"].items()}
        key_cols = {}
        for name in meta["key_order"]:
            spec = meta["keys"][name]
            if "strbuf" in spec:
                key_cols[name] = np.asarray(
                    _strbuf_lookup(bufs, f"kd:{name}", f"ko:{name}"),
                    dtype=object,
                )
            elif "jsonvals" in spec:
                key_cols[name] = np.asarray(
                    _dict_values_restore(spec["jsonvals"], key_dtypes[name]),
                    dtype=object,
                )
            else:
                if spec["buf"] not in bufs:
                    raise InvalidArgument(f"wire: missing key buffer {spec['buf']!r}")
                key_cols[name] = bufs[spec["buf"]]
        states = {}
        for out_name, paths in meta["states"].items():
            leaves = {}
            for p in paths:
                bname = f"s:{out_name}:{p}"
                if bname not in bufs:
                    raise InvalidArgument(f"wire: missing state buffer {bname!r}")
                leaves[p] = bufs[bname]
            states[out_name] = _unflatten(leaves)
        pb = PartialAggBatch(
            key_cols=key_cols,
            key_dtypes=key_dtypes,
            states=states,
            in_types={
                k: (DT(v) if v is not None else None)
                for k, v in meta["in_types"].items()
            },
        )
        pb.wire_meta = meta  # type: ignore[attr-defined]
        return kind, pb
    raise InvalidArgument(f"wire: unknown kind {kind!r}")
