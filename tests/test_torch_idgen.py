"""Snowflake id generator tests (reference: IdGenerator.scala:13-92).

The port's copy of ``tests/test_idgen.py``: imports point at
``chanamq_tpu_torch``, every broker's router on the CPU; the
assertions are the reference's.
"""

import threading

import pytest

from chanamq_tpu_torch.cluster.idgen import IdGenerator, MAX_WORKER_ID


def test_monotonic_unique():
    gen = IdGenerator(worker_id=1)
    ids = gen.next_ids(10_000)
    assert ids == sorted(ids)
    assert len(set(ids)) == len(ids)


def test_worker_id_embedded():
    gen = IdGenerator(worker_id=42)
    assert (gen.next_id() >> 12) & 0x3FF == 42


def test_timestamp_extraction():
    import time

    gen = IdGenerator(worker_id=0)
    before = int(time.time() * 1000)
    ts = IdGenerator.timestamp_ms(gen.next_id())
    after = int(time.time() * 1000)
    assert before <= ts <= after


def test_worker_id_bounds():
    with pytest.raises(ValueError):
        IdGenerator(worker_id=MAX_WORKER_ID + 1)
    with pytest.raises(ValueError):
        IdGenerator(worker_id=-1)


def test_thread_safety():
    gen = IdGenerator(worker_id=3)
    all_ids = []
    lock = threading.Lock()

    def worker():
        ids = [gen.next_id() for _ in range(2000)]
        with lock:
            all_ids.extend(ids)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(set(all_ids)) == len(all_ids)
