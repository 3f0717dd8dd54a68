"""Builtin scalar UDFs and UDAs.

Parity targets: reference src/carnot/funcs/builtins/{math_ops.cc, string_ops.cc,
conditionals.cc, math_sketches.h, json_ops.cc, ...} (~300 builtins).  Device
numeric functions are torch functions over column tensors; string functions
are host functions evaluated over dictionary values (O(unique)).

Not ported yet (they need a package a later slice brings): the metadata
functions (upid_to_pod_name, ... and the ambient asid / _exec_hostname, slice
6 with metadata/).
"""
from __future__ import annotations

import dataclasses

import re

import torch

from pixie_tpu_torch.ops.chain import remainder
from pixie_tpu_torch.types import DataType as DT
from pixie_tpu_torch.udf.udf import (
    AnyUDA,
    CountUDA,
    MaxUDA,
    MeanUDA,
    MinUDA,
    QuantileUDA,
    QuantilesUDA,
    Registry,
    ScalarUDF,
    StddevUDA,
    SumUDA,
    VarianceUDA,
)

_B, _I, _F, _S, _T = DT.BOOLEAN, DT.INT64, DT.FLOAT64, DT.STRING, DT.TIME64NS


def _dev(name, args, out, fn, op):
    """A device fn; `op` names its chain program opcode (ops/chain.py
    DEV_OPS), which computes what fn computes."""
    return ScalarUDF(name=name, arg_types=tuple(args), out_type=out, fn=fn, device=True,
                     op=op)


def _host(name, args, out, fn):
    return ScalarUDF(name=name, arg_types=tuple(args), out_type=out, fn=fn, device=False)


def _enum(name, out, fn, lo, hi):
    """Bounded-int-domain decoder → device LUT (see eval._int_domain_call)."""
    return ScalarUDF(
        name=name, arg_types=(_I,), out_type=out, fn=fn, device=False, int_domain=(lo, hi)
    )


def register_all(r: Registry) -> None:
    # ---------------------------------------------------------------- numeric
    for args in ((_I, _I), (_F, _F)):
        out = args[0]
        r.register(_dev("add", args, out, lambda a, b: a + b, "add"))
        r.register(_dev("subtract", args, out, lambda a, b: a - b, "subtract"))
        r.register(_dev("multiply", args, out, lambda a, b: a * b, "multiply"))
        r.register(_dev("modulo", args, out, lambda a, b: torch.where(b != 0, remainder(a, torch.where(b == 0, 1, b)), 0), "modulo"))
    # Division always yields float (PxL / Python semantics).
    r.register(_dev("divide", (_F, _F), _F, lambda a, b: a.to(torch.float64) / b, "divide"))
    r.register(_dev("floordiv", (_I, _I), _I, lambda a, b: torch.where(b != 0, a // torch.where(b == 0, 1, b), 0), "floordiv"))
    r.register(_dev("pow", (_F, _F), _F, lambda a, b: torch.pow(a.to(torch.float64), b), "pow"))
    r.register(_dev("abs", (_F,), _F, torch.abs, "abs"))
    r.register(_dev("abs", (_I,), _I, torch.abs, "abs"))
    r.register(_dev("log", (_F,), _F, torch.log, "log"))
    r.register(_dev("log2", (_F,), _F, torch.log2, "log2"))
    r.register(_dev("log10", (_F,), _F, torch.log10, "log10"))
    r.register(_dev("exp", (_F,), _F, torch.exp, "exp"))
    r.register(_dev("sqrt", (_F,), _F, torch.sqrt, "sqrt"))
    r.register(_dev("ceil", (_F,), _F, lambda a: torch.ceil(a), "ceil"))
    r.register(_dev("floor", (_F,), _F, lambda a: torch.floor(a), "floor"))
    r.register(_dev("round", (_F,), _F, lambda a: torch.round(a), "round"))
    # time binning: px.bin(t, size) — truncate to window start
    r.register(dataclasses.replace(
        _dev("bin", (_T, _I), _T, lambda t, s: t - t % torch.where(s == 0, 1, s), "bin"),
        st_preserve=True))
    r.register(dataclasses.replace(
        _dev("bin", (_I, _I), _I, lambda t, s: t - t % torch.where(s == 0, 1, s), "bin"),
        st_preserve=True))

    # ------------------------------------------------------------ comparisons
    for args in ((_I, _I), (_F, _F), (_B, _B), (_T, _T)):
        r.register(_dev("equal", args, _B, lambda a, b: a == b, "eq"))
        r.register(_dev("not_equal", args, _B, lambda a, b: a != b, "ne"))
    for args in ((_I, _I), (_F, _F), (_T, _T)):
        r.register(_dev("less", args, _B, lambda a, b: a < b, "lt"))
        r.register(_dev("less_equal", args, _B, lambda a, b: a <= b, "le"))
        r.register(_dev("greater", args, _B, lambda a, b: a > b, "gt"))
        r.register(_dev("greater_equal", args, _B, lambda a, b: a >= b, "ge"))

    # ----------------------------------------------------------------- logical
    r.register(_dev("logical_and", (_B, _B), _B, torch.logical_and, "and"))
    r.register(_dev("logical_or", (_B, _B), _B, torch.logical_or, "or"))
    r.register(_dev("logical_not", (_B,), _B, torch.logical_not, "not"))

    # ------------------------------------------------------------ conditionals
    # select on numerics is a device where(); select on strings is handled by the
    # evaluator via code translation (reference builtins/conditionals.cc).
    for t in (_I, _F, _B, _T):
        r.register(_dev("select", (_B, t, t), t, lambda c, a, b: torch.where(c, a, b),
                        "select"))

    # More math (reference math_ops.cc)
    r.register(_dev("ln", (_F,), _F, torch.log, "log"))
    r.register(_dev("negate", (_F,), _F, lambda a: -a, "negate"))
    r.register(_dev("negate", (_I,), _I, lambda a: -a, "negate"))
    r.register(_dev("invert", (_F,), _F, lambda a: 1.0 / a, "invert"))
    # time casts (reference string_ops int64_to_time / time_to_int64)
    r.register(_dev("int64_to_time", (_I,), _T, lambda a: a, "identity"))
    r.register(_dev("time_to_int64", (_T,), _I, lambda a: a, "identity"))

    # ------------------------------------------------------------ string (host)
    r.register(_host("length", (_S,), _I, lambda s: len(s)))
    r.register(_host("contains", (_S, _S), _B, lambda s, sub: sub in s))
    r.register(_host("find", (_S, _S), _I, lambda s, sub: s.find(sub)))
    r.register(_host("to_upper", (_S,), _S, lambda s: s.upper()))
    r.register(_host("to_lower", (_S,), _S, lambda s: s.lower()))
    r.register(_host("toupper", (_S,), _S, lambda s: s.upper()))
    r.register(_host("tolower", (_S,), _S, lambda s: s.lower()))
    r.register(_host("trim", (_S,), _S, lambda s: s.strip()))
    r.register(_host("atoi", (_S,), _I, _atoi))
    r.register(_host("atoi", (_S, _I), _I, _atoi_default))
    # String concatenation (reference string_ops.cc StringConcat / '+'):
    # two dict columns evaluate over the observed pair cross-product LUT.
    r.register(_host("add", (_S, _S), _S, lambda a, b: (a or "") + (b or "")))
    # URI ops (reference funcs/builtins/uri_ops.cc): parse → JSON struct,
    # recompose from parts.
    r.register(_host("uri_parse", (_S,), _S, _uri_parse))
    r.register(_host("uri_recompose", (_S, _S, _I, _S), _S,
                     lambda scheme, host, port, path:
                     f"{scheme}://{host}" + (f":{port}" if port >= 0 else "") + (path or "")))
    # Rule matcher (reference _match_regex_rule): value × JSON {rule: regex}
    # → first matching rule name, else "".
    r.register(_host("_match_regex_rule", (_S, _S), _S, _match_regex_rule))
    r.register(_host("bytes_to_hex", (_S,), _S, lambda s: s.encode().hex()))
    r.register(_host("hex_to_ascii", (_S,), _S, _hex_to_ascii))
    # strip_prefix(prefix, s) — reference string_ops.cc argument order.
    r.register(_host("strip_prefix", (_S, _S), _S,
                     lambda prefix, s: s[len(prefix):] if s.startswith(prefix) else s))
    r.register(
        _host(
            "substring",
            (_S, _I, _I),
            _S,
            lambda s, start, length: s[start : start + length],
        )
    )
    # regex_match(pattern, s) — reference regex_ops.cc argument order.
    r.register(
        _host(
            "regex_match",
            (_S, _S),
            _B,
            lambda pattern, s: re.fullmatch(pattern, s) is not None,
        )
    )
    # replace(pattern, s, sub): regex replace (reference regex_ops.cc).
    r.register(_host("replace", (_S, _S, _S), _S,
                     lambda pattern, s, sub: re.sub(pattern, sub, s)))
    r.register(
        _host(
            "regex_replace",
            (_S, _S, _S),
            _S,
            lambda s, pattern, repl: re.sub(pattern, repl, s),
        )
    )

    # ---------------------------------------------------------------- JSON ops
    # (reference json_ops.cc; evaluated over unique strings only)
    r.register(_host("pluck", (_S, _S), _S, _pluck_str))
    r.register(_host("pluck_int64", (_S, _S), _I, _pluck_int))
    r.register(_host("pluck_float64", (_S, _S), _F, _pluck_float))
    r.register(_host("pluck_array", (_S, _I), _S, _pluck_array))

    # --------------------------------------------------------- SQL normalization
    # (reference sql_ops.cc: replace literals with placeholders)
    r.register(_host("normalize_mysql", (_S,), _S, _normalize_sql))
    r.register(_host("normalize_pgsql", (_S,), _S, _normalize_sql))
    r.register(_host("normalize_sql", (_S,), _S, _normalize_sql))
    # 2-arg forms take the protocol command (mysql: int code, pgsql: tag
    # string) and normalize only query-bearing commands (reference
    # sql_ops.cc NormalizeMySQLUDF/NormalizePostgresUDF signatures).
    r.register(_host("normalize_mysql", (_S, _I), _S,
                     lambda q, cmd: _normalize_struct(q)))
    r.register(_host("normalize_pgsql", (_S, _S), _S,
                     lambda q, cmd: _normalize_struct(q)))
    # JSON query-struct form the sql_queries scripts pluck fields out of
    # (reference sql_ops.cc returns {"query": ..., "params": [...], "error"}).
    r.register(_host("normalize_sql_struct", (_S,), _S, _normalize_struct))

    # ------------------------------------------------------------ PII redaction
    # (reference pii_ops.cc best-effort regex redaction)
    r.register(_host("redact_pii_best_effort", (_S,), _S, _redact_pii))

    # --------------------------------------------------- protocol enum decoders
    # Bounded-int-domain → device LUT (reference funcs/protocols/*.cc).
    r.register(_enum("http_resp_message", _S, _http_resp_message, 100, 599))
    r.register(_enum("kafka_api_key_name", _S, _kafka_api_key_name, 0, 67))
    r.register(_enum("mysql_command_name", _S, _mysql_command_name, 0, 32))
    r.register(_enum("protocol_name", _S, _protocol_name, 0, 12))

    # ------------------------------------------------ mixed-type overloads
    # (reference math_ops.cc registers every UDF for all numeric type pairs.)
    # Registry.scalar's numeric widening would RESOLVE most of these to the
    # float overloads with the same results; they are registered explicitly
    # anyway to mirror the reference's registration surface, pin the exact
    # out_types independently of widening-rule evolution, and skip the
    # per-call cast closure on the hot dispatch path.
    for args in ((_I, _F), (_F, _I)):
        r.register(_dev("add", args, _F, lambda a, b: a + b, "add"))
        r.register(_dev("subtract", args, _F, lambda a, b: a - b, "subtract"))
        r.register(_dev("multiply", args, _F, lambda a, b: a * b, "multiply"))
    for args in ((_I, _I), (_I, _F), (_F, _I)):
        r.register(_dev("divide", args, _F,
                        lambda a, b: a.to(torch.float64) / b, "divide"))
    r.register(_dev("floordiv", (_F, _F), _F,
                    lambda a, b: torch.where(b != 0, a // torch.where(b == 0, 1., b), 0.),
                    "floordiv"))
    r.register(_dev("pow", (_I, _I), _F,
                    lambda a, b: torch.pow(a.to(torch.float64), b), "pow"))
    r.register(_dev("pow", (_I, _F), _F,
                    lambda a, b: torch.pow(a.to(torch.float64), b), "pow"))
    r.register(_dev("pow", (_F, _I), _F, lambda a, b: torch.pow(a, b), "pow"))
    # time arithmetic: offsets stay times, differences are durations
    r.register(dataclasses.replace(
        _dev("add", (_T, _I), _T, lambda a, b: a + b, "add"), st_preserve=True))
    r.register(dataclasses.replace(
        _dev("add", (_I, _T), _T, lambda a, b: a + b, "add"), st_preserve=True))
    r.register(dataclasses.replace(
        _dev("subtract", (_T, _I), _T, lambda a, b: a - b, "subtract"), st_preserve=True))
    r.register(_dev("subtract", (_T, _T), _I, lambda a, b: a - b, "subtract"))
    # int inputs to float math (implicit widening, reference type expansion)
    for fname, fn in (("log", torch.log), ("ln", torch.log), ("log2", torch.log2),
                      ("log10", torch.log10), ("exp", torch.exp),
                      ("sqrt", torch.sqrt)):
        r.register(_dev(fname, (_I,), _F,
                        lambda a, fn=fn: fn(a.to(torch.float64)),
                        "log" if fname == "ln" else fname))
    for fname in ("ceil", "floor", "round"):
        r.register(_dev(fname, (_I,), _I, lambda a: a, fname))  # already integral
    # 1.0 / an int64 tensor would be float32 (torch's default dtype); the
    # reference computes it in float64
    r.register(_dev("invert", (_I,), _F, lambda a: 1.0 / a.to(torch.float64), "invert"))
    for args in ((_I, _F), (_F, _I)):
        r.register(_dev("equal", args, _B, lambda a, b: a == b, "eq"))
        r.register(_dev("not_equal", args, _B, lambda a, b: a != b, "ne"))
        r.register(_dev("less", args, _B, lambda a, b: a < b, "lt"))
        r.register(_dev("less_equal", args, _B, lambda a, b: a <= b, "le"))
        r.register(_dev("greater", args, _B, lambda a, b: a > b, "gt"))
        r.register(_dev("greater_equal", args, _B, lambda a, b: a >= b, "ge"))
    # lexical string comparisons (host pair/LUT eval; reference string
    # comparisons via StringValue operator<)
    r.register(_host("less", (_S, _S), _B, lambda a, b: a < b))
    r.register(_host("less_equal", (_S, _S), _B, lambda a, b: a <= b))
    r.register(_host("greater", (_S, _S), _B, lambda a, b: a > b))
    r.register(_host("greater_equal", (_S, _S), _B, lambda a, b: a >= b))

    # ---------------------------- reference-spelling aliases (math_ops.cc
    # registers comparison/logical ops under camelCase PxL names)
    for args in ((_I, _I), (_F, _F), (_T, _T)):
        r.register(_dev("greaterThan", args, _B, lambda a, b: a > b, "gt"))
        r.register(_dev("greaterThanEqual", args, _B, lambda a, b: a >= b, "ge"))
        r.register(_dev("lessThan", args, _B, lambda a, b: a < b, "lt"))
        r.register(_dev("lessThanEqual", args, _B, lambda a, b: a <= b, "le"))
        r.register(_dev("notEqual", args, _B, lambda a, b: a != b, "ne"))
    r.register(_dev("logicalAnd", (_B, _B), _B, torch.logical_and, "and"))
    r.register(_dev("logicalOr", (_B, _B), _B, torch.logical_or, "or"))
    r.register(_dev("logicalNot", (_B,), _B, torch.logical_not, "not"))
    # approxEqual: |a-b| < 1e-9 (reference math_ops.cc ApproxEqualUDF)
    r.register(_dev("approxEqual", (_F, _F), _B,
                    lambda a, b: torch.abs(a - b) < 1e-9, "approx_eq"))

    # ------------------------------------------- environment constants
    # (reference metadata_ops.cc VizierIDUDF / VizierNameUDF,
    #  exec_host_num_cpus) — nullary host calls evaluate at compile time
    # (eval._host_call all-literal path).  asid and _exec_hostname read the
    # metadata state and wait for the metadata slice.
    r.register(_host("vizier_id", (), _S, _vizier_id))
    r.register(_host("vizier_name", (), _S, _vizier_name))
    r.register(_host("_exec_host_num_cpus", (), _I,
                     lambda: __import__("os").cpu_count() or 1))
    # int → string; evaluable when the int derives from a dictionary column
    # (origin composition) or literals — arbitrary dense int columns have no
    # bounded value domain to LUT over.
    r.register(_host("itoa", (_I,), _S, lambda v: str(int(v))))

    # ---------------------------------------------------------------- ML ops
    # (reference ml_ops.h: TransformerUDF/_text_embedding via tflite,
    # SentencePieceUDF/_encode_sentence_piece, KMeansUDF/_kmeans_inference.
    # No model weights ship in this environment: the embedder is a
    # deterministic hashed char-ngram embedding with the same shape contract
    # — JSON float vector in, JSON float vector out — documented substitute.)
    r.register(_host("_text_embedding", (_S,), _S, _text_embedding))
    r.register(_host("_encode_sentence_piece", (_S,), _S,
                     _encode_sentence_piece))
    r.register(_host("_kmeans_inference", (_S, _S), _I, _kmeans_inference))
    r.register(_host("_predict_request_path_cluster", (_S, _S), _S,
                     _predict_request_path_cluster))

    # -------------------------------------------------------------------- UDAs
    r.register_uda("count", CountUDA)
    r.register_uda("sum", SumUDA)
    r.register_uda("mean", MeanUDA)
    r.register_uda("min", MinUDA)
    r.register_uda("max", MaxUDA)
    r.register_uda("stddev", StddevUDA)
    r.register_uda("variance", VarianceUDA)
    r.register_uda("any", AnyUDA)
    # reference 'sample' UDA: a representative group member.  Deterministic
    # here (same picker as any) — order-independent across shards/batches.
    r.register_uda("sample", AnyUDA)
    r.register_uda("quantiles", QuantilesUDA)
    for q in (0.01, 0.10, 0.25, 0.50, 0.75, 0.90, 0.95, 0.99):
        r.register_uda(f"p{int(round(q*100)):02d}", (lambda q=q: QuantileUDA(q)))


# ------------------------------------------------------------- host fn helpers


def _vizier_id() -> str:
    from pixie_tpu_torch import flags

    return flags.define_str(
        "PX_VIZIER_ID", "00000000-0000-0000-0000-000000000000", "cluster id")


def _vizier_name() -> str:
    # default MUST match the pxmodule intrinsic's definition — the flags
    # registry rejects same-flag redefinition with a different default
    from pixie_tpu_torch import flags

    return flags.define_str("PX_VIZIER_NAME", "pixie-tpu-cluster",
                            "cluster name")


_EMBED_DIM = 64


def _text_embedding(doc: str) -> str:
    """Deterministic hashed char-trigram embedding (L2-normalized JSON
    vector).  Substitute for the reference's tflite transformer executor
    (ml_ops.h TransformerUDF) — same contract, no model weights needed."""
    import json as _json
    import math as _math
    import zlib as _zlib

    vec = [0.0] * _EMBED_DIM
    s = f"^{doc}$"
    for i in range(len(s) - 2):
        h = _zlib.crc32(s[i: i + 3].encode())
        vec[h % _EMBED_DIM] += 1.0 if (h >> 16) & 1 else -1.0
    norm = _math.sqrt(sum(v * v for v in vec)) or 1.0
    return _json.dumps([round(v / norm, 6) for v in vec])


def _encode_sentence_piece(doc: str) -> str:
    """Whitespace+punctuation tokenizer → stable hashed token ids (JSON).
    Substitute for the reference's sentencepiece model (ml_ops.h
    SentencePieceUDF) with the same ids-list contract."""
    import json as _json
    import zlib as _zlib

    toks = re.findall(r"[A-Za-z0-9_]+|[^\sA-Za-z0-9_]", doc)
    return _json.dumps([_zlib.crc32(t.lower().encode()) % 32000 for t in toks])


def _kmeans_inference(embedding_json: str, model_json: str) -> int:
    """Nearest centroid (reference ml_ops.h KMeansUDF: embedding × kmeans
    model json → cluster index)."""
    import json as _json

    try:
        x = _json.loads(embedding_json)
        model = _json.loads(model_json)
        cents = model.get("centroids", model) if isinstance(model, dict) \
            else model
        best, best_d = -1, float("inf")
        for i, c in enumerate(cents):
            d = sum((a - b) ** 2 for a, b in zip(x, c))
            if d < best_d:
                best, best_d = i, d
        return best
    except (ValueError, TypeError):
        return -1


def _predict_request_path_cluster(req_path: str, clusters_json: str) -> str:
    """Nearest request-path cluster by template similarity (reference
    request_path_ops.cc PredictRequestPathClusterUDF: path × clustering
    model → representative template)."""
    import json as _json

    from pixie_tpu_torch.ml.request_path import RequestPathClustering

    try:
        clusters = _json.loads(clusters_json)
    except (ValueError, TypeError):
        return ""
    if not isinstance(clusters, list) or not clusters:
        return ""
    model = RequestPathClustering()
    model.templates = sorted(
        c.get("template", "") if isinstance(c, dict) else str(c)
        for c in clusters
    )
    return model.predict(req_path)


def _atoi(s: str) -> int:
    try:
        return int(s.strip())
    except (ValueError, TypeError, AttributeError):
        return 0


def _atoi_default(s: str, default: int) -> int:
    try:
        return int(s.strip())
    except (ValueError, TypeError, AttributeError):
        return int(default)


def _hex_to_ascii(s: str) -> str:
    try:
        return bytes.fromhex(s).decode("ascii", errors="replace")
    except ValueError:
        return ""


def _json_get(s: str, key: str):
    import json

    try:
        obj = json.loads(s)
    except (ValueError, TypeError):
        return None
    if isinstance(obj, dict):
        return obj.get(key)
    return None


def _pluck_str(s: str, key: str) -> str:
    import json

    v = _json_get(s, key)
    if v is None:
        return ""
    if isinstance(v, str):
        return v
    return json.dumps(v, separators=(",", ":"))


def _pluck_int(s: str, key: str) -> int:
    v = _json_get(s, key)
    try:
        return int(v)
    except (ValueError, TypeError):
        return 0


def _pluck_float(s: str, key: str) -> float:
    v = _json_get(s, key)
    try:
        return float(v)
    except (ValueError, TypeError):
        return float("nan")


def _pluck_array(s: str, idx: int) -> str:
    import json

    try:
        obj = json.loads(s)
    except (ValueError, TypeError):
        return ""
    if isinstance(obj, list) and -len(obj) <= idx < len(obj):
        v = obj[idx]
        return v if isinstance(v, str) else json.dumps(v, separators=(",", ":"))
    return ""


_SQL_STRING_RE = re.compile(r"'(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\"")
_SQL_NUMBER_RE = re.compile(r"\b\d+(?:\.\d+)?\b")


def _normalize_sql(q: str) -> str:
    q = _SQL_STRING_RE.sub("?", q)
    q = _SQL_NUMBER_RE.sub("?", q)
    return re.sub(r"\s+", " ", q).strip()


def _uri_parse(uri: str) -> str:
    import json as _json
    from urllib.parse import parse_qsl, urlsplit

    try:
        u = urlsplit(uri or "")
        # .port/.hostname parse lazily and can ALSO raise (bad port text)
        out = {
            "scheme": u.scheme, "host": u.hostname or "",
            "port": -1 if u.port is None else u.port,  # 0 is a real port
            "path": u.path, "fragment": u.fragment,
            "query": dict(parse_qsl(u.query)),
        }
    except ValueError:
        return _json.dumps({"error": "unparseable uri"})
    return _json.dumps(out)


def _match_regex_rule(value: str, rules_json: str) -> str:
    import json as _json

    try:
        rules = _json.loads(rules_json or "{}")
    except ValueError:
        return ""
    if not isinstance(rules, dict):
        return ""
    for name, pattern in rules.items():
        try:
            if re.search(pattern, value or ""):
                return name
        except (re.error, TypeError):
            continue
    return ""


def _normalize_struct(q: str) -> str:
    import json as _json

    return _json.dumps({"query": _normalize_sql(q or ""), "params": [], "error": ""})


_PII_RES = [
    re.compile(r"[\w.+-]+@[\w-]+\.[\w.-]+"),                       # email
    re.compile(r"\b(?:\d{1,3}\.){3}\d{1,3}\b"),                    # IPv4
    re.compile(r"\b(?:[0-9a-fA-F]{1,4}:){4,7}[0-9a-fA-F]{0,4}\b"),  # IPv6-ish
    re.compile(r"\b(?:\d[ -]?){13,19}\b"),                         # card numbers
]


def _redact_pii(s: str) -> str:
    for rx in _PII_RES:
        s = rx.sub("<REDACTED>", s)
    return s


def _http_resp_message(code: int) -> str:
    import http.client

    return http.client.responses.get(code, "Unknown")


_KAFKA_APIS = {
    0: "Produce", 1: "Fetch", 2: "ListOffsets", 3: "Metadata", 4: "LeaderAndIsr",
    5: "StopReplica", 6: "UpdateMetadata", 7: "ControlledShutdown", 8: "OffsetCommit",
    9: "OffsetFetch", 10: "FindCoordinator", 11: "JoinGroup", 12: "Heartbeat",
    13: "LeaveGroup", 14: "SyncGroup", 15: "DescribeGroups", 16: "ListGroups",
    17: "SaslHandshake", 18: "ApiVersions", 19: "CreateTopics", 20: "DeleteTopics",
    21: "DeleteRecords", 22: "InitProducerId", 23: "OffsetForLeaderEpoch",
    24: "AddPartitionsToTxn", 25: "AddOffsetsToTxn", 26: "EndTxn",
    27: "WriteTxnMarkers", 28: "TxnOffsetCommit", 29: "DescribeAcls", 30: "CreateAcls",
    31: "DeleteAcls", 32: "DescribeConfigs", 33: "AlterConfigs",
    34: "AlterReplicaLogDirs", 35: "DescribeLogDirs", 36: "SaslAuthenticate",
    37: "CreatePartitions", 38: "CreateDelegationToken", 39: "RenewDelegationToken",
    40: "ExpireDelegationToken", 41: "DescribeDelegationToken", 42: "DeleteGroups",
    43: "ElectLeaders", 44: "IncrementalAlterConfigs", 45: "AlterPartitionReassignments",
    46: "ListPartitionReassignments", 47: "OffsetDelete", 48: "DescribeClientQuotas",
    49: "AlterClientQuotas", 50: "DescribeUserScramCredentials",
    51: "AlterUserScramCredentials", 56: "AlterIsr", 57: "UpdateFeatures",
    60: "DescribeCluster", 61: "DescribeProducers", 65: "DescribeTransactions",
    66: "ListTransactions", 67: "AllocateProducerIds",
}


def _kafka_api_key_name(key: int) -> str:
    return _KAFKA_APIS.get(key, "Unknown")


_MYSQL_COMMANDS = {
    0: "Sleep", 1: "Quit", 2: "InitDB", 3: "Query", 4: "FieldList", 5: "CreateDB",
    6: "DropDB", 7: "Refresh", 8: "Shutdown", 9: "Statistics", 10: "ProcessInfo",
    11: "Connect", 12: "ProcessKill", 13: "Debug", 14: "Ping", 15: "Time",
    16: "DelayedInsert", 17: "ChangeUser", 18: "BinlogDump", 19: "TableDump",
    20: "ConnectOut", 21: "RegisterSlave", 22: "StmtPrepare", 23: "StmtExecute",
    24: "StmtSendLongData", 25: "StmtClose", 26: "StmtReset", 27: "SetOption",
    28: "StmtFetch", 29: "Daemon", 30: "BinlogDumpGTID", 31: "ResetConnection",
}


def _mysql_command_name(cmd: int) -> str:
    return _MYSQL_COMMANDS.get(cmd, "Unknown")


#: Traffic protocol enum for this framework's socket tracing tables (our own
#: ordering; reference has an equivalent enum in stirling socket_tracer).
PROTOCOLS = {
    0: "unknown", 1: "http", 2: "http2", 3: "mysql", 4: "cql", 5: "pgsql",
    6: "dns", 7: "redis", 8: "nats", 9: "mux", 10: "kafka", 11: "mongo", 12: "amqp",
}


def _protocol_name(p: int) -> str:
    return PROTOCOLS.get(p, "unknown")
