"""Router match kernels: CUDA wrappers, launch counts, plain versions.

``topic_match`` and ``headers_match`` compute what
``chanamq_tpu/router/compile.py::_topic_kernel`` and ``::_headers_kernel``
compute: for each message b, the OR of the queue bitmask rows of every
binding row that matches it, as ``[B, W]`` int32 bit patterns.

A compiled binding table is fixed for its generation, so it is checked
once, when it is uploaded: ``topic_table`` and ``headers_table`` take the
compiled row-major tensors, check them, and add what the kernels read
beside them (the token and pair-id tables transposed, so that a warp's
read of one cell over 32 rows is one line; the headers table's pair-id
count). A call then checks only its message tensors.

On CUDA tensors the wrappers launch the hand-written kernels of
``csrc/router_match.cu`` (built on first use, see ``build.py``) or raise;
on CPU tensors they run the plain PyTorch versions ``topic_match_ref`` and
``headers_match_ref``. Nothing falls back from one to the other.

Masks are int32 bit patterns of the reference's uint32 words: torch has no
uint32 shift on the CPU, and the caller views the result back to
``np.uint32`` before decoding it.

Each wrapper's ``launches`` attribute counts its kernel launches, and only
those, so a run can show that its main path went through the kernel.
``prepare_topic_match`` and ``prepare_headers_match`` check a call's CUDA
inputs and bind its launch; the wrappers launch what they return, and a
timing loop can launch it again without the checks (and without counting).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build

PAD = -2  # a cell past a row's length (compile.py's PAD)
MAX_TOKENS = 32  # a topic table's P and S (compile.py MAX_PATTERN_WORDS)
MAX_ROWS = 65536  # a table's rows (the kernels keep a hit bit a row)
MAX_IDS = 65536   # a headers table's pair ids (a bit each, a message)
MSGS_PER_BLOCK = (1, 2, 4)  # the kernels' instances

_I32 = torch.int32

_ptr = ctypes.c_void_p
_int = ctypes.c_int


def library() -> ctypes.CDLL:
    """The built ``csrc/router_match.cu`` with its C signatures declared."""
    lib, _ = build.load("router_match")
    if not getattr(lib, "_chana_typed", False):
        lib.chana_topic_match.argtypes = [_ptr] * 10 + [_int] * 6 + [_ptr]
        lib.chana_topic_match.restype = _int
        lib.chana_headers_match.argtypes = [_ptr] * 6 + [_int] * 7 + [_ptr]
        lib.chana_headers_match.restype = _int
        lib.chana_cuda_error_string.argtypes = [_int]
        lib.chana_cuda_error_string.restype = ctypes.c_char_p
        lib._chana_typed = True
    return lib


def msgs_per_block(b: int) -> int:
    """Messages a block takes at batch ``b``: one while a block a message
    leaves SMs free, more as the batch grows, so that each row read is
    compared with several messages (the best of 1, 2 and 4 on an H100 at
    B = 16, 256 and 512-1,024)."""
    return 1 if b <= 128 else 2 if b <= 256 else 4


def _or_rows(ok: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """OR of ``masks[n]`` over the n with ``ok[b, n]``: ``[B, W]`` int32.

    torch has no OR reduction (no bitwise_or.reduce, no "or" in
    scatter_reduce), so the bits are expanded, counted with a matmul, and
    packed back. The counts are at most N, exact in float32."""
    n, w = masks.shape
    shifts = torch.arange(32, dtype=_I32, device=masks.device)
    bits = (masks[:, :, None] >> shifts) & 1                    # [N,W,32]
    hits = ok.to(torch.float32) @ bits.reshape(n, w * 32).to(torch.float32)
    on = (hits > 0).reshape(-1, w, 32).to(torch.int64)
    words = (on << shifts.to(torch.int64)).sum(dim=2)           # < 2**32
    return torch.where(words >= 2**31, words - 2**32, words).to(_I32)


def _check_rows(name: str, n: int) -> None:
    if n > MAX_ROWS:
        raise ValueError(f"{name}: {n} rows; the kernels take at most "
                         f"{MAX_ROWS}")


# -- topic -------------------------------------------------------------------


class TopicTable(NamedTuple):
    """A compiled topic table as the kernel takes it, checked once: the
    row-major tables (``compile.py``'s layout) and their transposes."""
    pre: torch.Tensor       # [N, P] int32, STAR/PAD cells
    suf: torch.Tensor       # [N, S] int32, right-aligned
    plen: torch.Tensor      # [N] int32
    slen: torch.Tensor      # [N] int32
    has_hash: torch.Tensor  # [N] bool
    masks: torch.Tensor     # [N, W] int32 bit patterns
    pre_t: torch.Tensor     # [P, N]: pre transposed
    suf_t: torch.Tensor     # [S, N]: suf transposed


def topic_table(pre, suf, plen, slen, has_hash, masks) -> TopicTable:
    """Check one compiled topic table's tensors (all on one device) and
    add their transposes. Raises on a wrong dtype, shape or device."""
    device = pre.device
    for name, t, dt, nd in (("pre", pre, _I32, 2), ("suf", suf, _I32, 2),
                            ("plen", plen, _I32, 1), ("slen", slen, _I32, 1),
                            ("has_hash", has_hash, torch.bool, 1),
                            ("masks", masks, _I32, 2)):
        build.check(name, t, dt, nd, device)
    n, p = pre.shape
    s = suf.shape[1]
    for name, t, shape in (("suf", suf, (n, s)), ("plen", plen, (n,)),
                           ("slen", slen, (n,)), ("has_hash", has_hash, (n,)),
                           ("masks", masks, (n, masks.shape[1]))):
        build.check_shape(name, t, shape)
    if p > MAX_TOKENS or s > MAX_TOKENS:
        raise ValueError(f"topic table: P={p}, S={s}; at most {MAX_TOKENS}")
    _check_rows("topic table", n)
    return TopicTable(pre, suf, plen, slen, has_hash, masks,
                      pre.t().contiguous(), suf.t().contiguous())


def topic_match_ref(table: TopicTable, pre_m, suf_m, mlen) -> torch.Tensor:
    """Plain PyTorch version of the topic kernel (any device)."""
    pre, suf = table.pre, table.suf
    pm = ((pre[None, :, :] == pre_m[:, None, :])
          | (pre[None, :, :] < 0)).all(dim=2)
    sm = ((suf[None, :, :] == suf_m[:, None, :])
          | (suf[None, :, :] < 0)).all(dim=2)
    need = table.plen[None, :] + table.slen[None, :]
    len_ok = torch.where(table.has_hash[None, :], mlen[:, None] >= need,
                         mlen[:, None] == table.plen[None, :])
    return _or_rows(pm & sm & len_ok, table.masks)


def prepare_topic_match(table: TopicTable, pre_m, suf_m, mlen, *,
                        mb: int | None = None):
    """Check the topic kernel's CUDA message inputs and bind its launch.

    Returns ``(out, launch)``: ``launch()`` runs the kernel into ``out``;
    it is None when there is nothing to launch (an empty batch or table,
    ``out`` already final). ``mb`` overrides ``msgs_per_block``. Raises on
    a wrong dtype, shape or device."""
    device = table.pre.device
    if device.type != "cuda":
        raise ValueError(f"topic_match: no kernel for device {device}")
    n, p = table.pre.shape
    s = table.suf.shape[1]
    w = table.masks.shape[1]
    build.check("pre_m", pre_m, _I32, 2, device)
    b = pre_m.shape[0]
    build.check_shape("pre_m", pre_m, (b, p))
    build.check("suf_m", suf_m, _I32, 2, device)
    build.check_shape("suf_m", suf_m, (b, s))
    build.check("mlen", mlen, _I32, 1, device)
    build.check_shape("mlen", mlen, (b,))
    out = torch.empty((b, w), dtype=_I32, device=device)
    if b == 0 or w == 0:
        return out, None
    if n == 0:
        return out.zero_(), None
    lib = library()
    return out, build.launcher(
        lib, lib.chana_topic_match, "topic_match", device,
        table.pre_t.data_ptr(), table.suf_t.data_ptr(),
        table.plen.data_ptr(), table.slen.data_ptr(),
        table.has_hash.data_ptr(), table.masks.data_ptr(), pre_m.data_ptr(),
        suf_m.data_ptr(), mlen.data_ptr(), out.data_ptr(), b, n, p, s, w,
        mb or msgs_per_block(b))


def topic_match(table: TopicTable, pre_m, suf_m, mlen) -> torch.Tensor:
    """Topic match of B messages against a table's N pattern rows: ``[B,
    W]`` int32. Message ``pre_m [B,P]``, ``suf_m [B,S]`` int32
    (MISS-padded), ``mlen [B]`` int32, on the table's device."""
    if table.pre.device.type == "cpu":
        return topic_match_ref(table, pre_m, suf_m, mlen)
    out, launch = prepare_topic_match(table, pre_m, suf_m, mlen)
    if launch is not None:
        launch()
        topic_match.launches += 1
    return out


topic_match.launches = 0


# -- headers -----------------------------------------------------------------


class HeadersTable(NamedTuple):
    """A compiled headers table as the kernel takes it, checked once."""
    req: torch.Tensor     # [N, R] int32 pair ids, PAD-padded
    rcount: torch.Tensor  # [N] int32
    is_all: torch.Tensor  # [N] bool
    masks: torch.Tensor   # [N, W] int32 bit patterns
    req_t: torch.Tensor   # [R, N]: req transposed
    vocab: int            # pair ids are 0 .. vocab - 1 (at least 1)


def headers_table(req, rcount, is_all, masks) -> HeadersTable:
    """Check one compiled headers table's tensors (all on one device): its
    cells are PAD or pair ids in ``[0, MAX_IDS)``. Adds the transpose and
    the pair-id count, the largest id plus one."""
    device = req.device
    for name, t, dt, nd in (("req", req, _I32, 2),
                            ("rcount", rcount, _I32, 1),
                            ("is_all", is_all, torch.bool, 1),
                            ("masks", masks, _I32, 2)):
        build.check(name, t, dt, nd, device)
    n = req.shape[0]
    for name, t, shape in (("rcount", rcount, (n,)), ("is_all", is_all, (n,)),
                           ("masks", masks, (n, masks.shape[1]))):
        build.check_shape(name, t, shape)
    _check_rows("headers table", n)
    ids = req[req != PAD]
    top = int(ids.max()) if ids.numel() else 0
    if ids.numel() and (int(ids.min()) < 0 or top >= MAX_IDS):
        raise ValueError(f"headers table: pair ids must be PAD or in "
                         f"[0, {MAX_IDS}); got {int(ids.min())}..{top}")
    return HeadersTable(req, rcount, is_all, masks, req.t().contiguous(),
                        top + 1)


def headers_match_ref(table: HeadersTable, pids) -> torch.Tensor:
    """Plain PyTorch version of the headers kernel (any device)."""
    req = table.req
    eq = (req[None, :, :, None] == pids[:, None, None, :]).any(dim=3)
    cnt = (eq & (req[None, :, :] != PAD)).sum(dim=2, dtype=_I32)  # [B,N]
    ok = torch.where(table.is_all[None, :], cnt == table.rcount[None, :],
                     cnt > 0)
    return _or_rows(ok, table.masks)


def prepare_headers_match(table: HeadersTable, pids, *,
                          mb: int | None = None):
    """Check the headers kernel's CUDA message input and bind its launch:
    ``(out, launch)`` as ``prepare_topic_match`` returns them."""
    device = table.req.device
    if device.type != "cuda":
        raise ValueError(f"headers_match: no kernel for device {device}")
    n, r = table.req.shape
    w = table.masks.shape[1]
    build.check("pids", pids, _I32, 2, device)
    b, h = pids.shape
    out = torch.empty((b, w), dtype=_I32, device=device)
    if b == 0 or w == 0:
        return out, None
    if n == 0:
        return out.zero_(), None
    lib = library()
    return out, build.launcher(
        lib, lib.chana_headers_match, "headers_match", device,
        table.req_t.data_ptr(), table.rcount.data_ptr(),
        table.is_all.data_ptr(), table.masks.data_ptr(), pids.data_ptr(),
        out.data_ptr(), b, n, r, h, w, table.vocab, mb or msgs_per_block(b))


def headers_match(table: HeadersTable, pids) -> torch.Tensor:
    """Headers match of B messages against a table's N binding rows:
    ``[B, W]`` int32. Message pair ids ``pids [B,H]`` int32 (MISS-padded),
    on the table's device."""
    if table.req.device.type == "cpu":
        return headers_match_ref(table, pids)
    out, launch = prepare_headers_match(table, pids)
    if launch is not None:
        launch()
        headers_match.launches += 1
    return out


headers_match.launches = 0
