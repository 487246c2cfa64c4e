"""Codec round-trip + canonicality tests."""

import pytest

from mochi_tpu_torch.protocol.codec import decode, encode


CASES = [
    None,
    True,
    False,
    0,
    1,
    127,
    128,
    2**40,
    -1,
    -2**40,
    b"",
    b"\x00\xff" * 10,
    "",
    "hello é世界",
    [],
    [1, "two", b"three", None, [4, [5]]],
    {},
    {"b": 1, "a": [2, {"z": None}], "c": b"x"},
]


@pytest.mark.parametrize("value", CASES, ids=range(len(CASES)))
def test_roundtrip(value):
    assert decode(encode(value)) == value


def test_dict_key_order_canonical():
    assert encode({"a": 1, "b": 2}) == encode({"b": 2, "a": 1})


def test_tuple_encodes_as_list():
    assert decode(encode((1, 2))) == [1, 2]


def test_trailing_bytes_rejected():
    with pytest.raises(ValueError):
        decode(encode(1) + b"\x00")


def test_truncated_rejected():
    data = encode([1, "abc", b"xyz"])
    for cut in range(1, len(data)):
        with pytest.raises(ValueError):
            decode(data[:cut])


def test_non_str_dict_key_rejected():
    with pytest.raises(TypeError):
        encode({1: "x"})


def test_unknown_type_rejected():
    with pytest.raises(TypeError):
        encode(1.5)


def test_deep_nesting_guard():
    value = []
    for _ in range(100):
        value = [value]
    with pytest.raises(ValueError):
        encode(value)


@pytest.mark.parametrize("value", CASES, ids=range(len(CASES)))
def test_bytes_equal_the_reference_codec(value):
    """The port's codec and the reference's encode every case to the same
    bytes, and each decodes the other's."""
    from mochi_tpu.protocol import codec as ref_codec

    data = encode(value)
    assert data == ref_codec.encode(value)
    assert ref_codec.decode(data) == decode(data)
