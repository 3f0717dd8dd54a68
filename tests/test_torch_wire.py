"""The partial_agg wire frame: pixie_tpu_torch against pixie_tpu.

LocalCluster round-trips every agent's partial aggregate through this frame,
so the port keeps the reference's bytes: the same PartialAggBatch encodes to
identical bytes in both packages (plain and zlib-compressed), and a frame
encoded by either package decodes in the other to an equal batch.
"""
import numpy as np
import pytest

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
from pixie_tpu import flags as ref_flags
from pixie_tpu.parallel.partial import PartialAggBatch as RefBatch
from pixie_tpu.services import wire as ref_wire
from pixie_tpu.types import DataType as RefDT, UInt128 as RefU128

from pixie_tpu_torch import flags as port_flags
from pixie_tpu_torch.parallel.partial import PartialAggBatch
from pixie_tpu_torch.services import wire
from pixie_tpu_torch.status import InvalidArgument
from pixie_tpu_torch.types import DataType as DT, UInt128


def _fields(kind: str, seed: int):
    """(key_cols, key_dtype ints, states, in_type ints) of one batch."""
    rng = np.random.default_rng(seed)
    g = 37
    keys = {"service": np.asarray([f"svc-{i}" for i in rng.permutation(g)], dtype=object),
            "status": rng.choice([200, 404, 500], g).astype(np.int64)}
    kdt = {"service": int(DT.STRING), "status": int(DT.INT64)}
    if kind == "upid":
        keys["upid"] = [(1, int(i)) for i in range(g)]
        kdt["upid"] = int(DT.UINT128)
    if kind == "none":
        keys, kdt, g = {}, {}, 1
    states = {
        "cnt": rng.integers(0, 1 << 40, g).astype(np.int64),
        "avg_lat": {"sum": rng.normal(size=g), "count": rng.integers(0, 99, g)},
        "p50": rng.integers(0, 50, (g, 514)).astype(np.float32),
        "lo": rng.normal(size=g),
    }
    in_types = {"cnt": None, "avg_lat": int(DT.FLOAT64), "p50": int(DT.FLOAT64),
                "lo": int(DT.FLOAT64)}
    return keys, kdt, states, in_types


def _batch(cls, dt_cls, u128_cls, kind, seed):
    keys, kdt, states, in_types = _fields(kind, seed)
    if "upid" in keys:
        keys = {**keys, "upid": np.asarray([u128_cls(*v) for v in keys["upid"]],
                                           dtype=object)}
    return cls(key_cols=keys, key_dtypes={k: dt_cls(v) for k, v in kdt.items()},
               states=states,
               in_types={k: (dt_cls(v) if v is not None else None)
                         for k, v in in_types.items()})


def _same(a, b):
    assert list(a.key_cols) == list(b.key_cols)
    for k in a.key_cols:
        assert int(a.key_dtypes[k]) == int(b.key_dtypes[k])
        assert [str(v) for v in np.asarray(a.key_cols[k]).tolist()] == \
            [str(v) for v in np.asarray(b.key_cols[k]).tolist()]
    assert {k: (None if v is None else int(v)) for k, v in a.in_types.items()} == \
        {k: (None if v is None else int(v)) for k, v in b.in_types.items()}

    def walk(x, y):
        if isinstance(x, dict):
            assert sorted(x) == sorted(y)
            for k in x:
                walk(x[k], y[k])
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            assert np.asarray(x).dtype == np.asarray(y).dtype

    walk(a.states, b.states)


@pytest.fixture(params=["", "zlib:0"])
def compress(request):
    ref_flags.set_for_testing("PL_WIRE_COMPRESS", request.param)
    port_flags.set_for_testing("PL_WIRE_COMPRESS", request.param)
    yield request.param
    ref_flags.set_for_testing("PL_WIRE_COMPRESS", "")
    port_flags.set_for_testing("PL_WIRE_COMPRESS", "")


@pytest.mark.parametrize("kind", ["keys", "upid", "none"])
def test_partial_agg_frame_bytes_identical(compress, kind):
    ref = _batch(RefBatch, RefDT, RefU128, kind, 1)
    port = _batch(PartialAggBatch, DT, UInt128, kind, 1)
    assert wire.encode_partial_agg(port) == ref_wire.encode_partial_agg(ref)
    assert port.to_bytes() == ref.to_bytes()


@pytest.mark.parametrize("kind", ["keys", "upid", "none"])
def test_partial_agg_frame_decodes_across_packages(compress, kind):
    ref = _batch(RefBatch, RefDT, RefU128, kind, 2)
    port = _batch(PartialAggBatch, DT, UInt128, kind, 2)
    _same(PartialAggBatch.from_bytes(ref.to_bytes()), ref)
    _same(RefBatch.from_bytes(port.to_bytes()), port)
    back = PartialAggBatch.from_bytes(port.to_bytes())
    assert isinstance(back, PartialAggBatch)
    _same(back, port)


def test_other_frames_wait_for_the_services_slice():
    """The json frame is ported (byte for byte the reference's, decoded
    across packages; tests/test_torch_journal.py holds the host_batch
    frame); a frame of no known kind is still refused."""
    meta = {"msg": "hello", "req_id": 7, "nested": {"a": [1, 2.5, None]}}
    assert wire.encode_json(meta) == ref_wire.encode_json(meta)
    assert wire.decode_frame(ref_wire.encode_json(meta)) == ("json", meta)
    assert ref_wire.decode_frame(wire.encode_json(meta)) == ("json", meta)
    assert (wire.encode_error(3, "boom", retry_after_s=0.25, retryable=True)
            == ref_wire.encode_error(3, "boom", retry_after_s=0.25, retryable=True))
    raw = {"plan": '{"ops": [1, 2]}'}
    assert wire.encode_json_raw({"msg": "run"}, raw) == ref_wire.encode_json_raw({"msg": "run"}, raw)
    with pytest.raises(InvalidArgument):
        wire.decode_frame(b"XXXX\x00\x00\x00\x00")
