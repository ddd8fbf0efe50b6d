"""Router match kernels: CUDA wrappers, launch counts, plain versions.

``topic_match`` and ``headers_match`` compute what
``chanamq_tpu/router/compile.py::_topic_kernel`` and ``::_headers_kernel``
compute: for each message b, the OR of the queue bitmask rows of every
binding row that matches it, as ``[B, W]`` int32 bit patterns.

On CUDA tensors they launch the hand-written kernels of
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

import torch

from . import build

PAD = -2  # a cell past a row's length (compile.py's PAD)

_I32 = torch.int32

_ptr = ctypes.c_void_p
_int = ctypes.c_int


def library() -> ctypes.CDLL:
    """The built ``csrc/router_match.cu`` with its C signatures declared."""
    lib, _ = build.load("router_match")
    if not getattr(lib, "_chana_typed", False):
        lib.chana_topic_match.argtypes = [_ptr] * 10 + [_int] * 5 + [_ptr]
        lib.chana_topic_match.restype = _int
        lib.chana_headers_match.argtypes = [_ptr] * 6 + [_int] * 5 + [_ptr]
        lib.chana_headers_match.restype = _int
        lib.chana_cuda_error_string.argtypes = [_int]
        lib.chana_cuda_error_string.restype = ctypes.c_char_p
        lib._chana_typed = True
    return lib


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


# -- topic -------------------------------------------------------------------


def topic_match_ref(pre, suf, plen, slen, has_hash, masks,
                    pre_m, suf_m, mlen) -> torch.Tensor:
    """Plain PyTorch version of the topic kernel (any device)."""
    pm = ((pre[None, :, :] == pre_m[:, None, :])
          | (pre[None, :, :] < 0)).all(dim=2)
    sm = ((suf[None, :, :] == suf_m[:, None, :])
          | (suf[None, :, :] < 0)).all(dim=2)
    need = plen[None, :] + slen[None, :]
    len_ok = torch.where(has_hash[None, :], mlen[:, None] >= need,
                         mlen[:, None] == plen[None, :])
    return _or_rows(pm & sm & len_ok, masks)


def prepare_topic_match(pre, suf, plen, slen, has_hash, masks,
                        pre_m, suf_m, mlen):
    """Check the topic kernel's CUDA inputs and bind its launch.

    Returns ``(out, launch)``: ``launch()`` runs the kernel into ``out``;
    it is None when there is nothing to launch (an empty batch or table,
    ``out`` already final). Raises on a wrong dtype, shape or device."""
    device = pre.device
    if device.type != "cuda":
        raise ValueError(f"topic_match: no kernel for device {device}")
    for name, t, dt, nd in (("pre", pre, _I32, 2), ("suf", suf, _I32, 2),
                            ("plen", plen, _I32, 1), ("slen", slen, _I32, 1),
                            ("has_hash", has_hash, torch.bool, 1),
                            ("masks", masks, _I32, 2),
                            ("pre_m", pre_m, _I32, 2),
                            ("suf_m", suf_m, _I32, 2),
                            ("mlen", mlen, _I32, 1)):
        build.check(name, t, dt, nd, device)
    n, p = pre.shape
    s = suf.shape[1]
    w = masks.shape[1]
    b = pre_m.shape[0]
    for name, t, shape in (("suf", suf, (n, s)), ("plen", plen, (n,)),
                           ("slen", slen, (n,)), ("has_hash", has_hash, (n,)),
                           ("masks", masks, (n, w)), ("pre_m", pre_m, (b, p)),
                           ("suf_m", suf_m, (b, s)), ("mlen", mlen, (b,))):
        build.check_shape(name, t, shape)
    out = torch.empty((b, w), dtype=_I32, device=device)
    if b == 0 or w == 0:
        return out, None
    if n == 0:
        return out.zero_(), None
    lib = library()
    return out, build.launcher(
        lib, lib.chana_topic_match, "topic_match", device,
        pre.data_ptr(), suf.data_ptr(), plen.data_ptr(), slen.data_ptr(),
        has_hash.data_ptr(), masks.data_ptr(), pre_m.data_ptr(),
        suf_m.data_ptr(), mlen.data_ptr(), out.data_ptr(), b, n, p, s, w)


def topic_match(pre, suf, plen, slen, has_hash, masks,
                pre_m, suf_m, mlen) -> torch.Tensor:
    """Topic match of B messages against N pattern rows: ``[B, W]`` int32.

    ``pre [N,P]``, ``suf [N,S]`` int32 (STAR/PAD cells; the suffix is
    right-aligned), ``plen``/``slen [N]`` int32, ``has_hash [N]`` bool,
    ``masks [N,W]`` int32; message ``pre_m [B,P]``, ``suf_m [B,S]`` int32
    (MISS-padded), ``mlen [B]`` int32."""
    if pre.device.type == "cpu":
        return topic_match_ref(pre, suf, plen, slen, has_hash, masks,
                               pre_m, suf_m, mlen)
    out, launch = prepare_topic_match(pre, suf, plen, slen, has_hash, masks,
                                      pre_m, suf_m, mlen)
    if launch is not None:
        launch()
        topic_match.launches += 1
    return out


topic_match.launches = 0


# -- headers -----------------------------------------------------------------


def headers_match_ref(req, rcount, is_all, masks, pids) -> torch.Tensor:
    """Plain PyTorch version of the headers kernel (any device)."""
    eq = (req[None, :, :, None] == pids[:, None, None, :]).any(dim=3)
    cnt = (eq & (req[None, :, :] != PAD)).sum(dim=2, dtype=_I32)  # [B,N]
    ok = torch.where(is_all[None, :], cnt == rcount[None, :], cnt > 0)
    return _or_rows(ok, masks)


def prepare_headers_match(req, rcount, is_all, masks, pids):
    """Check the headers kernel's CUDA inputs and bind its launch:
    ``(out, launch)`` as ``prepare_topic_match`` returns them."""
    device = req.device
    if device.type != "cuda":
        raise ValueError(f"headers_match: no kernel for device {device}")
    for name, t, dt, nd in (("req", req, _I32, 2),
                            ("rcount", rcount, _I32, 1),
                            ("is_all", is_all, torch.bool, 1),
                            ("masks", masks, _I32, 2),
                            ("pids", pids, _I32, 2)):
        build.check(name, t, dt, nd, device)
    n, r = req.shape
    w = masks.shape[1]
    b, h = pids.shape
    for name, t, shape in (("rcount", rcount, (n,)), ("is_all", is_all, (n,)),
                           ("masks", masks, (n, w))):
        build.check_shape(name, t, shape)
    if h * 4 > 48 * 1024:
        raise ValueError(f"headers_match: {h} pair ids per message exceed "
                         "the kernel's shared memory")
    out = torch.empty((b, w), dtype=_I32, device=device)
    if b == 0 or w == 0:
        return out, None
    if n == 0:
        return out.zero_(), None
    lib = library()
    return out, build.launcher(
        lib, lib.chana_headers_match, "headers_match", device,
        req.data_ptr(), rcount.data_ptr(), is_all.data_ptr(),
        masks.data_ptr(), pids.data_ptr(), out.data_ptr(), b, n, r, h, w)


def headers_match(req, rcount, is_all, masks, pids) -> torch.Tensor:
    """Headers match of B messages against N binding rows: ``[B, W]`` int32.

    ``req [N,R]`` int32 (PAD-padded pair ids), ``rcount [N]`` int32,
    ``is_all [N]`` bool, ``masks [N,W]`` int32; message pair ids
    ``pids [B,H]`` int32 (MISS-padded)."""
    if req.device.type == "cpu":
        return headers_match_ref(req, rcount, is_all, masks, pids)
    out, launch = prepare_headers_match(req, rcount, is_all, masks, pids)
    if launch is not None:
        launch()
        headers_match.launches += 1
    return out


headers_match.launches = 0
