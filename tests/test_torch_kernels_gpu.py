"""The port's CUDA router match kernels against their plain PyTorch
versions, on the card. Marked ``gpu``; skipped where no CUDA device is
present. Run on a machine with a card:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q

Each kernel is also held against the JAX package's own kernel body
(``_topic_kernel(np, ...)``, ``_headers_kernel(np, ...)``) on the same
numpy inputs. The outputs are integer bitmasks, so the comparison is exact.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from chanamq_tpu.router import compile as ref_compile
from chanamq_tpu_torch.kernels import router_match as rm
from chanamq_tpu_torch.router.tables import tables_from_numpy

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


# (N rows, W mask words, B messages, token widths): the router's caps at
# full token widths, the shapes chip_smoke's main path gives the kernels
# (topic P=8, S=4; headers 512 rows over 16 mask words, R=4, H=8), odd
# sizes, and one table wider than a block's row chunk (1024) so the chunk
# loop runs twice
TOPIC_SHAPES = [(512, 128, 1024, 8, 8), (512, 128, 16, 8, 8),
                (512, 128, 512, 8, 4), (37, 3, 5, 8, 8), (1, 1, 1, 2, 2),
                (1500, 7, 33, 8, 8)]
HEADERS_SHAPES = [(512, 128, 1024, 8, 16), (512, 128, 16, 8, 16),
                  (512, 16, 512, 4, 8), (37, 3, 5, 8, 16), (1, 1, 1, 2, 2),
                  (1500, 7, 33, 8, 16)]


@pytest.mark.parametrize("n,w,b,p,s", TOPIC_SHAPES)
def test_topic_kernel_matches_plain(cuda, n, w, b, p, s):
    rng = np.random.default_rng(n * 1000 + w)
    table = chip_smoke.topic_tables(rng, n, w, p, s)
    t = tables_from_numpy(table, cuda)
    msg_np = chip_smoke.topic_messages(rng, table, b)
    msg = [torch.from_numpy(a).to(cuda) for a in msg_np]
    args = (t["pre"], t["suf"], t["plen"], t["slen"], t["has_hash"],
            t["masks"], *msg)
    before = rm.topic_match.launches
    got = rm.topic_match(*args)
    torch.cuda.synchronize()
    assert rm.topic_match.launches == before + 1
    want = rm.topic_match_ref(*args)
    assert got.dtype == torch.int32 and got.shape == (b, w)
    assert torch.equal(got, want)
    # and the JAX package's own kernel body on the same numpy inputs
    ref = ref_compile._topic_kernel(
        np, table["pre"], table["suf"], table["plen"], table["slen"],
        table["has_hash"], table["masks"], *msg_np)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), ref)


@pytest.mark.parametrize("n,w,b,r,h", HEADERS_SHAPES)
def test_headers_kernel_matches_plain(cuda, n, w, b, r, h):
    rng = np.random.default_rng(n * 1000 + w + 1)
    table = chip_smoke.headers_tables(rng, n, w, r)
    t = tables_from_numpy(table, cuda)
    pids_np = chip_smoke.headers_messages(rng, table, b, h)
    pids = torch.from_numpy(pids_np).to(cuda)
    args = (t["req"], t["rcount"], t["is_all"], t["masks"], pids)
    before = rm.headers_match.launches
    got = rm.headers_match(*args)
    torch.cuda.synchronize()
    assert rm.headers_match.launches == before + 1
    assert torch.equal(got, rm.headers_match_ref(*args))
    ref = ref_compile._headers_kernel(
        np, table["req"], table["rcount"], table["is_all"], table["masks"],
        pids_np)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), ref)


def test_kernel_rejects_bad_input(cuda):
    table = chip_smoke.topic_tables(np.random.default_rng(0), 8, 1)
    t = tables_from_numpy(table, cuda)
    pre_m, suf_m, mlen = (torch.from_numpy(a).to(cuda) for a in
                          chip_smoke.topic_messages(
                              np.random.default_rng(1), table, 4))
    with pytest.raises(TypeError):
        rm.topic_match(t["pre"].long(), t["suf"], t["plen"], t["slen"],
                       t["has_hash"], t["masks"], pre_m, suf_m, mlen)
    with pytest.raises(ValueError):
        rm.topic_match(t["pre"], t["suf"], t["plen"], t["slen"],
                       t["has_hash"], t["masks"], pre_m.cpu(), suf_m, mlen)
