"""Method registry + generic codec tests for all 8 AMQP classes.

The port's copy of ``tests/test_methods.py``: imports point at
``chanamq_tpu_torch``; the assertions are the reference's.
"""

import pytest

from chanamq_tpu_torch.amqp import methods as m


def roundtrip(method):
    return m.decode_method(method.encode())


def test_registry_covers_all_classes():
    # connection 12, channel 6, access 2, exchange 8, queue 10, basic 18,
    # confirm 2, tx 6 = 64 methods
    assert m.registry_size() == 64


def test_connection_start_golden_prefix():
    start = m.Connection.Start(
        version_major=0, version_minor=9,
        server_properties={"product": "chanamq-tpu"},
        mechanisms=b"PLAIN EXTERNAL", locales=b"en_US",
    )
    enc = start.encode()
    # class 10, method 10, major 0, minor 9
    assert enc[:6] == b"\x00\x0a\x00\x0a\x00\x09"
    dec = roundtrip(start)
    assert dec == start
    assert dec.server_properties == {"product": "chanamq-tpu"}
    assert dec.mechanisms == b"PLAIN EXTERNAL"


def test_basic_publish_bits_golden():
    pub = m.Basic.Publish(exchange="ex", routing_key="rk", mandatory=True, immediate=False)
    enc = pub.encode()
    # class 60 method 40, ticket 0, "ex", "rk", bits=0b01
    assert enc == b"\x00\x3c\x00\x28\x00\x00\x02ex\x02rk\x01"
    assert roundtrip(pub) == pub


def test_bit_packing_shares_one_octet():
    d = m.Queue.Declare(queue="q", passive=False, durable=True,
                        exclusive=False, auto_delete=True, nowait=False)
    enc = d.encode()
    # bits durable(1)+auto_delete(3) -> 0b01010 = 0x0a, one octet before table
    assert enc == b"\x00\x32\x00\x0a\x00\x00\x01q\x0a\x00\x00\x00\x00"
    dec = roundtrip(d)
    assert dec.durable is True and dec.auto_delete is True
    assert dec.passive is False and dec.exclusive is False


def test_access_request_five_bits():
    r = m.Access.Request(realm="/data", exclusive=True, passive=False,
                         active=True, write=False, read=True)
    dec = roundtrip(r)
    assert (dec.exclusive, dec.passive, dec.active, dec.write, dec.read) == (
        True, False, True, False, True)


def test_all_methods_roundtrip_defaults():
    from chanamq_tpu_torch.amqp.methods import _registry
    for (cid, mid), cls in _registry.items():
        inst = cls()
        dec = roundtrip(inst)
        assert dec == inst, cls.NAME
        assert (dec.CLASS_ID, dec.METHOD_ID) == (cid, mid)


def test_exchange_unbind_ok_is_51():
    assert m.Exchange.UnbindOk.METHOD_ID == 51


def test_basic_nack_roundtrip():
    n = m.Basic.Nack(delivery_tag=123456789, multiple=True, requeue=True)
    dec = roundtrip(n)
    assert dec.delivery_tag == 123456789
    assert dec.multiple and dec.requeue


def test_content_flags():
    assert m.Basic.Publish.HAS_CONTENT
    assert m.Basic.Deliver.HAS_CONTENT
    assert m.Basic.Return.HAS_CONTENT
    assert m.Basic.GetOk.HAS_CONTENT
    assert not m.Basic.Ack.HAS_CONTENT
    assert not m.Queue.Declare.HAS_CONTENT


def test_unknown_method_raises():
    with pytest.raises(m.MethodDecodeError):
        m.decode_method(b"\x00\x63\x00\x63")


def test_unexpected_field_raises():
    with pytest.raises(TypeError):
        m.Basic.Publish(nope=1)
