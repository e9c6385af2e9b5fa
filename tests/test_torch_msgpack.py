"""The port's msgpack decoder (``utils/msgpack.py``) against msgpack and flax.

Hypothesis-made trees of every type family, packed by ``msgpack.packb``
with ``use_bin_type=True`` as flax packs, decode as ``msgpack.unpackb``
decodes them; flax ``to_bytes`` trees with f32, int32, 0-d, numpy-scalar,
complex and bf16 leaves and a chunked leaf decode as
``flax.serialization.msgpack_restore`` gives them; truncated or unknown
input raises ``ValueError`` with the byte offset.
"""

import math

import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
from flax import serialization

from torch_port_util import module_time_limit, time_limit  # noqa: F401
from vectorquantizedcpc_tpu_torch.utils.msgpack import unpackb

TIME_LIMIT_S = 60  # each test's own limit (torch_port_util.time_limit)

scalars = st.one_of(
    st.none(),
    st.booleans(),
    st.integers(min_value=-(2 ** 63), max_value=2 ** 64 - 1),
    st.floats(allow_nan=True),
    st.text(max_size=40),
    st.text(min_size=32, max_size=300),  # str 8 / str 16
    st.binary(max_size=300),
)
trees = st.recursive(
    scalars,
    lambda inner: st.one_of(
        st.lists(inner, max_size=20),
        st.dictionaries(st.text(max_size=10), inner, max_size=20),
    ),
    max_leaves=60,
)


def _same(a, b) -> bool:
    if isinstance(b, float):
        return isinstance(a, float) and (a == b or (math.isnan(a) and math.isnan(b)))
    if isinstance(b, list):
        return isinstance(a, list) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(b, dict):
        return isinstance(a, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in b)
    return type(a) is type(b) and a == b


@settings(max_examples=200, deadline=None)
@given(tree=trees, single_float=st.booleans())
def test_trees_decode_as_msgpack_decodes_them(tree, single_float):
    data = msgpack.packb(tree, use_bin_type=True, use_single_float=single_float)
    assert _same(unpackb(data), msgpack.unpackb(data, raw=False, strict_map_key=False))


@settings(max_examples=50, deadline=None)
@given(n=st.sampled_from([0, 15, 16, 2 ** 16 - 1, 2 ** 16, 70_000]))
def test_wide_containers(n):
    """array 16 / 32, map 16 / 32, bin 16 / 32."""
    for value in (list(range(n)), {str(i): i for i in range(n)}, bytes(n)):
        data = msgpack.packb(value, use_bin_type=True)
        assert unpackb(data) == msgpack.unpackb(data, strict_map_key=False)


def _check_restore(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _check_restore(got[k], want[k], f"{path}/{k}")
    elif isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16, path
        assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32)), path
        assert tuple(got.shape) == np.shape(want), path
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        assert got.shape == want.shape and np.array_equal(got, want), path
    else:
        assert type(got) is type(want) and got == want, path


def test_flax_trees_decode_as_flax_restores_them():
    rng = np.random.default_rng(0)
    tree = {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "i32": np.arange(7, dtype=np.int32),
        "zero_d": np.asarray(5, np.int32),
        "f64_scalar": np.float64(2.5),
        "i8_scalar": np.int8(-3),
        "bf16": jnp.asarray(rng.normal(size=(2, 5)), jnp.bfloat16),
        "bf16_zero_d": jnp.asarray(1.5, jnp.bfloat16),
        "empty": np.zeros((0, 3), np.float32),
        "complex": 1.5 - 2j,
        "nested": {"tuple": (np.ones(2, np.float16), 3, "x"), "none": None, "flag": True},
    }
    data = serialization.to_bytes(tree)
    _check_restore(unpackb(data), serialization.msgpack_restore(data))


def test_chunked_leaves(monkeypatch):
    """flax writes a leaf over MAX_CHUNK_SIZE bytes as a chunked dict (the
    limit lowered here, in this test only)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"w": rng.normal(size=(9, 7)).astype(np.float32),
            "inner": {"b": jnp.asarray(rng.normal(size=(40,)), jnp.bfloat16)},
            "small": np.arange(4, dtype=np.int32)}
    data = serialization.msgpack_serialize(tree)
    raw = msgpack.unpackb(data, ext_hook=lambda c, d: msgpack.ExtType(c, d))
    assert raw["w"]["__msgpack_chunked_array__"] is True and len(raw["w"]["chunks"]) > 1
    _check_restore(unpackb(data), serialization.msgpack_restore(data))


@pytest.mark.parametrize("cut", [1, 2, 5, 37, -1])
def test_truncated_input_raises_with_the_offset(cut):
    data = serialization.to_bytes({"a": np.arange(10, dtype=np.float32), "b": "text"})
    with pytest.raises(ValueError, match=r"truncated input.* at byte \d+"):
        unpackb(data[:cut])


@pytest.mark.parametrize("data, match", [
    (b"", "empty input at byte 0"),
    (b"\xc1", "marker 0xc1 is outside the subset flax writes at byte 0"),
    (b"\x92\x01\xc1", "marker 0xc1 .* at byte 2"),
    (msgpack.packb(msgpack.ExtType(9, b"xyz")), "ext type 9 is outside the subset"),
    (msgpack.packb(msgpack.ExtType(1, msgpack.packb(((2,), "float32", b"\x00" * 4)))),
     "do not hold a float32 array"),
    (msgpack.packb(msgpack.ExtType(1, msgpack.packb(((1,), "nonsense", b"\x00")))),
     "unknown dtype 'nonsense'"),
    (msgpack.packb(1) + b"\x00", "1 bytes after the value at byte 1"),
    (b"\x81\x91\x01\x02", "a map key that is a map or an array at byte 1"),
    (b"\xa2\xff\xfe", "invalid utf-8"),
])
def test_unknown_input_raises_with_the_offset(data, match):
    with pytest.raises(ValueError, match=match):
        unpackb(data)


def test_arrays_are_views_of_the_input():
    """No copy of an array's bytes: a 55 MB tree decodes in well under a
    second (one read of each leaf's header)."""
    payload = np.arange(2 ** 20, dtype=np.float32)
    data = bytearray(serialization.to_bytes({"w": payload}))
    got = unpackb(data)["w"]
    assert np.shares_memory(got, np.frombuffer(data, np.uint8))
    np.testing.assert_array_equal(got, payload)
