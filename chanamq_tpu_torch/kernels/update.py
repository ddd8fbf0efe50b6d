"""The forecaster's parameter update: global-norm clip, momentum, SGD.

``clip_momentum_sgd`` computes ``make_train_step``'s update
(``chanamq_tpu/models/forecaster.py:142-152``) over every parameter
tensor at once, in place:

    sq = sum of every g^2
    s  = min(1, clip_norm * rsqrt(sq + 1e-12))   (1 if no clip)
    m  = 0.9 * m + g * s
    p  = p - lr * m

each operation rounded to float32 as written. On CUDA tensors it launches
the two kernels of ``csrc/forecaster_train.cu`` (the global sum of
squares, then the update, which reads the sum on the device, so a step
needs no host sync) or raises; on CPU tensors it runs the plain PyTorch
version ``clip_momentum_sgd_ref``. Nothing falls back from one to the
other. The reference donates its parameter and momentum buffers to the
jitted step (``parallel/mesh.py:73``); the port updates them in place.

The two launches are also wrappers of their own, for a caller that forms
``sq`` itself: ``sum_of_squares`` writes the sum of a list of gradients
into a caller's one-element float32 buffer, and ``momentum_sgd`` updates
from a caller's ``sq``. The sharded step (``parallel/mesh.py``) sums its
sharded and replicated gradients apart, all-reduces the first over its
tensor-parallel ranks and adds the second once, all on the device.

Each wrapper's ``launches`` counts its kernel launches:
``clip_momentum_sgd`` two a call with clipping, one without;
``sum_of_squares`` and ``momentum_sgd`` one a call. Every update returns
``s`` as a float32 tensor on the parameters' device. Given the same ``s``
(``scale=``) or the same ``sq``, the plain version updates bit for bit as
the kernel does; the sum of squares is taken in another order, so ``sq``
and ``s`` agree to float32 rounding.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from . import build

MOMENTUM = 0.9  # forecaster.py:149
_F32 = torch.float32
_ptr = ctypes.c_void_p
_int = ctypes.c_int


def library() -> ctypes.CDLL:
    """The built ``csrc/forecaster_train.cu``'s update launchers, typed."""
    lib, _ = build.load("forecaster_train")
    if not getattr(lib, "_chana_update_typed", False):
        lib.chana_update_max_tensors.argtypes = []
        lib.chana_update_max_tensors.restype = _int
        lib.chana_update_blocks.argtypes = [_ptr, _int]
        lib.chana_update_blocks.restype = _int
        lib.chana_sumsq.argtypes = [_ptr, _ptr, _int] + [_ptr] * 4
        lib.chana_sumsq.restype = _int
        lib.chana_momentum_sgd.argtypes = [_ptr] * 4 + [_int] + [_ptr] * 2 + [
            ctypes.c_float, _int, ctypes.c_float, ctypes.c_float, _ptr]
        lib.chana_momentum_sgd.restype = _int
        lib.chana_cuda_error_string.argtypes = [_int]
        lib.chana_cuda_error_string.restype = ctypes.c_char_p
        lib._chana_update_typed = True
    return lib


# -- plain versions ---------------------------------------------------------------


def sum_of_squares_ref(grads: Sequence[torch.Tensor],
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the sum-of-squares kernel: ``out[0]`` = the
    leaves' sums of squares added in the order given (the reference's
    ``tree_leaves`` order is the sorted names). ``out`` is a float32
    ``[1]`` tensor, made on the gradients' device when not given."""
    grads = list(grads)
    device = grads[0].device if grads else torch.device("cpu")
    total = torch.zeros((), dtype=_F32, device=device)
    for g in grads:
        total = total + torch.sum(torch.square(g))
    if out is None:
        return total.reshape(1)
    out.copy_(total.reshape(1))
    return out


def momentum_sgd_ref(params: Sequence[torch.Tensor],
                     momentum: Sequence[torch.Tensor],
                     grads: Sequence[torch.Tensor], lr: float,
                     sq: Optional[torch.Tensor],
                     clip_norm: Optional[float] = 1.0, *,
                     scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the update kernel: ``s`` from ``sq`` (``clip_norm``
    None: 1, and ``sq`` is not read), or ``scale`` if given, then the
    momentum and SGD update in place."""
    grads = list(grads)
    device = grads[0].device if grads else torch.device("cpu")
    if scale is not None:
        s = scale.reshape(())
    elif clip_norm is None:
        s = torch.ones((), dtype=_F32, device=device)
    else:
        s = torch.clamp(clip_norm * torch.rsqrt(sq.reshape(()) + 1e-12),
                        max=1.0)
    for p, m, g in zip(params, momentum, grads, strict=True):
        m.mul_(MOMENTUM)
        m.add_(g * s)  # s = 1 multiplies exactly
        p.sub_(lr * m)
    return s


def clip_momentum_sgd_ref(params: Sequence[torch.Tensor],
                          momentum: Sequence[torch.Tensor],
                          grads: Sequence[torch.Tensor], lr: float,
                          clip_norm: Optional[float] = 1.0, *,
                          scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version of the update kernels (any device), in the
    reference's order. ``scale``, if given, is used as ``s`` instead of
    computing it."""
    grads = list(grads)
    sq = (sum_of_squares_ref(grads)
          if scale is None and clip_norm is not None else None)
    return momentum_sgd_ref(params, momentum, grads, lr, sq, clip_norm,
                            scale=scale)


# -- kernels ----------------------------------------------------------------------


class _Table(NamedTuple):
    """Checked CUDA tensor lists, bound for the update's C launchers."""
    device: torch.device
    lib: ctypes.CDLL
    count: int
    arrays: dict  # {name: pointer array}
    sizes: ctypes.Array
    blocks: int


def _tables(what: str, tensors: dict) -> _Table:
    """Check each list of CUDA float32 tensors in ``tensors`` (one length,
    matching shapes, none empty) and build their pointer tables."""
    lists = {name: list(ts) for name, ts in tensors.items()}
    first = next(iter(lists.values()))
    if not first or any(len(ts) != len(first) for ts in lists.values()):
        raise ValueError(f"{what}: {', '.join(lists)} must be non-empty and "
                         "of one length")
    device = first[0].device
    if device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {device}")
    for i, t0 in enumerate(first):
        for name, ts in lists.items():
            build.check(f"{name} {i}", ts[i], _F32, t0.dim(), device)
            if ts is not first:
                build.check_shape(f"{name} {i}", ts[i], tuple(t0.shape))
        if t0.numel() == 0:
            raise ValueError(f"{what}: tensor {i} is empty")
    lib = library()
    count = len(first)
    if count > lib.chana_update_max_tensors():
        raise ValueError(f"{what}: {count} tensors; the kernel takes up to "
                         f"{lib.chana_update_max_tensors()}")
    ptrs = ctypes.c_void_p * count
    arrays = {name: ptrs(*(t.data_ptr() for t in ts))
              for name, ts in lists.items()}
    sizes = (ctypes.c_longlong * count)(*(t.numel() for t in first))
    blocks = lib.chana_update_blocks(sizes, count)
    if blocks <= 0:
        raise ValueError(f"{what}: the kernel refuses these sizes")
    return _Table(device, lib, count, arrays, sizes, blocks)


def _check_sq(what: str, sq: torch.Tensor, device) -> None:
    build.check(what, sq, _F32, 1, device)
    build.check_shape(what, sq, (1,))


def prepare_sum_of_squares(grads: Sequence[torch.Tensor], out: torch.Tensor,
                           *, table: Optional[_Table] = None):
    """Check the CUDA gradients and ``out`` (float32 ``[1]`` on their
    device) and bind the sum-of-squares launch, which writes ``out[0]``.
    ``table``: the gradients already checked and bound (``_tables`` with a
    ``grad`` list), as ``prepare_clip_momentum_sgd`` passes it."""
    t = table or _tables("sum_of_squares", {"grad": grads})
    _check_sq("sum_of_squares out", out, t.device)
    partial = torch.empty(t.blocks, dtype=_F32, device=t.device)
    counter = torch.zeros(1, dtype=torch.int32, device=t.device)
    launch = build.launcher(
        t.lib, t.lib.chana_sumsq, "sum_of_squares", t.device,
        t.arrays["grad"], t.sizes, t.count, partial.data_ptr(),
        out.data_ptr(), counter.data_ptr())
    launch.keep = (partial, counter, out)  # alive as long as the launch
    return launch


def prepare_momentum_sgd(params: Sequence[torch.Tensor],
                         momentum: Sequence[torch.Tensor],
                         grads: Sequence[torch.Tensor], lr: float,
                         sq: Optional[torch.Tensor],
                         clip_norm: Optional[float] = 1.0, *,
                         table: Optional[_Table] = None):
    """Check the update's CUDA tensors (and ``sq`` when clipping) and bind
    its launch: ``(scale, launch)``. ``table``: the three lists already
    checked and bound."""
    t = table or _tables("momentum_sgd", {
        "param": params, "momentum": momentum, "grad": grads})
    if clip_norm is not None:
        _check_sq("momentum_sgd sq", sq, t.device)
    scale = torch.empty(1, dtype=_F32, device=t.device)
    launch = build.launcher(
        t.lib, t.lib.chana_momentum_sgd, "momentum_sgd", t.device,
        t.arrays["param"], t.arrays["momentum"], t.arrays["grad"], t.sizes,
        t.count, None if clip_norm is None else sq.data_ptr(),
        scale.data_ptr(), 1.0 if clip_norm is None else float(clip_norm),
        int(clip_norm is not None), float(lr), MOMENTUM)
    launch.keep = (sq, scale)
    return scale.reshape(()), launch


def prepare_clip_momentum_sgd(params: Sequence[torch.Tensor],
                              momentum: Sequence[torch.Tensor],
                              grads: Sequence[torch.Tensor], lr: float,
                              clip_norm: Optional[float] = 1.0):
    """Check the update's CUDA tensors once and bind its launches:
    ``(scale, [launch, ...])``, the sum-of-squares launch first when
    clipping."""
    t = _tables("clip_momentum_sgd", {"param": params, "momentum": momentum,
                                      "grad": grads})
    launches, sq = [], None
    if clip_norm is not None:
        sq = torch.empty(1, dtype=_F32, device=t.device)
        launches.append(prepare_sum_of_squares(grads, sq, table=t))
    scale, update = prepare_momentum_sgd(params, momentum, grads, lr, sq,
                                         clip_norm, table=t)
    return scale, launches + [update]


def sum_of_squares(grads: Sequence[torch.Tensor],
                   out: torch.Tensor) -> torch.Tensor:
    """``out[0]`` = the sum of every ``g^2`` (float32), on the device, no
    host sync; returns ``out``."""
    if out.device.type == "cpu":
        return sum_of_squares_ref(grads, out)
    prepare_sum_of_squares(grads, out)()
    sum_of_squares.launches += 1
    return out


def momentum_sgd(params: Sequence[torch.Tensor],
                 momentum: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], lr: float,
                 sq: Optional[torch.Tensor],
                 clip_norm: Optional[float] = 1.0) -> torch.Tensor:
    """The clipped momentum SGD update of ``params`` and ``momentum``
    (float32, in place) by ``grads``, its clip scale from the caller's
    ``sq`` (not read when ``clip_norm`` is None); returns ``s``."""
    if params[0].device.type == "cpu":
        return momentum_sgd_ref(params, momentum, grads, lr, sq, clip_norm)
    scale, launch = prepare_momentum_sgd(params, momentum, grads, lr, sq,
                                         clip_norm)
    launch()
    momentum_sgd.launches += 1
    return scale


def clip_momentum_sgd(params: Sequence[torch.Tensor],
                      momentum: Sequence[torch.Tensor],
                      grads: Sequence[torch.Tensor], lr: float,
                      clip_norm: Optional[float] = 1.0) -> torch.Tensor:
    """The clipped momentum SGD update of ``params`` and ``momentum`` (float32,
    updated in place) by ``grads``; returns ``s``."""
    if params[0].device.type == "cpu":
        return clip_momentum_sgd_ref(params, momentum, grads, lr, clip_norm)
    scale, launches = prepare_clip_momentum_sgd(params, momentum, grads, lr,
                                                clip_norm)
    for launch in launches:
        launch()
        clip_momentum_sgd.launches += 1
    return scale


clip_momentum_sgd.launches = 0
sum_of_squares.launches = 0
momentum_sgd.launches = 0
