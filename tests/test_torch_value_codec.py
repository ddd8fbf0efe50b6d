"""Field-table value codec tests, including golden byte vectors.

The port's copy of ``tests/test_value_codec.py``: imports point at
``chanamq_tpu_torch``; the assertions are the reference's.
"""

import decimal
from io import BytesIO

import pytest

from chanamq_tpu_torch.amqp import value_codec as vc


def roundtrip_table(table):
    return vc.decode_table(vc.encode_table(table))


def test_empty_table_golden():
    assert vc.encode_table({}) == b"\x00\x00\x00\x00"
    assert vc.encode_table(None) == b"\x00\x00\x00\x00"


def test_longstr_value_golden():
    # key "a" -> longstr "hi": len=1,'a','S',len=2,'h','i'
    assert vc.encode_table({"a": "hi"}) == (
        b"\x00\x00\x00\x09" b"\x01a" b"S" b"\x00\x00\x00\x02hi"
    )


def test_int_value_golden():
    assert vc.encode_table({"n": 5}) == (b"\x00\x00\x00\x07" b"\x01n" b"I" b"\x00\x00\x00\x05")


def test_bool_and_void_golden():
    assert vc.encode_table({"t": True}) == b"\x00\x00\x00\x04\x01tt\x01"
    assert vc.encode_table({"v": None}) == b"\x00\x00\x00\x03\x01vV"


def test_roundtrip_all_types():
    table = {
        "str": "hello",
        "int": 42,
        "neg": -7,
        "big": 1 << 40,
        "bool_t": True,
        "bool_f": False,
        "float": 3.5,
        "bytes": b"\x00\x01\x02",
        "void": None,
        "dec": decimal.Decimal("3.14"),
        "ts": vc.Timestamp(1700000000),
        "nested": {"inner": "x", "deep": {"n": 1}},
        "arr": ["a", 1, True, None, {"k": "v"}],
    }
    out = roundtrip_table(table)
    assert out["str"] == "hello"
    assert out["int"] == 42
    assert out["neg"] == -7
    assert out["big"] == 1 << 40
    assert out["bool_t"] is True
    assert out["bool_f"] is False
    assert out["float"] == 3.5
    assert out["bytes"] == b"\x00\x01\x02"
    assert out["void"] is None
    assert out["dec"] == decimal.Decimal("3.14")
    assert out["ts"] == 1700000000
    assert isinstance(out["ts"], vc.Timestamp)
    assert out["nested"] == {"inner": "x", "deep": {"n": 1}}
    assert out["arr"] == ["a", 1, True, None, {"k": "v"}]


def test_read_signed_small_types():
    # 'b' int8, 's' int16, 'f' float32, 'l' int64 written directly
    stream = BytesIO()
    vc.write_shortstr(stream, "k")
    payload = stream.getvalue()
    body = payload + b"b\xff"  # -1 as int8
    data = len(body).to_bytes(4, "big") + body
    assert vc.decode_table(data) == {"k": -1}


def test_int32_boundary_uses_longlong():
    enc = vc.encode_table({"x": (1 << 31)})
    assert b"l" in enc
    assert roundtrip_table({"x": (1 << 31)})["x"] == 1 << 31


def test_shortstr_too_long_raises():
    with pytest.raises(vc.CodecError):
        vc.write_shortstr(BytesIO(), "x" * 256)


def test_truncated_table_raises():
    data = vc.encode_table({"a": "hello"})
    with pytest.raises(vc.CodecError):
        vc.decode_table(data[:-2] )


def test_unknown_tag_raises():
    body = b"\x01kZ"
    data = len(body).to_bytes(4, "big") + body
    with pytest.raises(vc.CodecError):
        vc.decode_table(data)


def test_roundtrip_randomized_nested():
    """Seeded fuzz: random deeply-nested tables/arrays of every supported
    value shape must round-trip exactly (the cluster RPC layer ships
    arbitrary payloads through this codec — queue.push_many batches carry
    lists of tables with bytes values)."""
    import random
    from io import BytesIO

    rng = random.Random(0xF1E1D)

    def rand_value(depth):
        kinds = ["int", "str", "bytes", "bool", "none", "float"]
        if depth < 3:
            kinds += ["table", "array"]
        kind = rng.choice(kinds)
        if kind == "int":
            return rng.randrange(-2**40, 2**40)
        if kind == "str":
            return "".join(rng.choice("abčé.💬x") for _ in range(rng.randrange(6)))
        if kind == "bytes":
            return bytes(rng.randrange(256) for _ in range(rng.randrange(8)))
        if kind == "bool":
            return rng.random() < 0.5
        if kind == "none":
            return None
        if kind == "float":
            return rng.randrange(-1000, 1000) / 8  # exact in binary
        if kind == "table":
            return {f"k{i}": rand_value(depth + 1)
                    for i in range(rng.randrange(4))}
        return [rand_value(depth + 1) for i in range(rng.randrange(4))]

    for trial in range(200):
        table = {f"key{i}": rand_value(0) for i in range(rng.randrange(6))}
        out = BytesIO()
        vc.write_table(out, table)
        back = vc.read_table(BytesIO(out.getvalue()))
        # bytes values come back as bytes; str as str — exact equality
        assert back == table, (trial, table, back)
