"""The forecaster's parameter update: global-norm clip, momentum, SGD.

``clip_momentum_sgd`` computes ``make_train_step``'s update
(``chanamq_tpu/models/forecaster.py:142-152``) over every parameter
tensor at once, in place:

    s = min(1, clip_norm * rsqrt(sum of every g^2 + 1e-12))   (1 if no clip)
    m = 0.9 * m + g * s
    p = p - lr * m

each operation rounded to float32 as written. On CUDA tensors it launches
the two kernels of ``csrc/forecaster_train.cu`` (the global sum of
squares, then the update, which reads the sum on the device, so a step
needs no host sync) or raises; on CPU tensors it runs the plain PyTorch
version ``clip_momentum_sgd_ref``. Nothing falls back from one to the
other. The reference donates its parameter and momentum buffers to the
jitted step (``parallel/mesh.py:73``); the port updates them in place.

``launches`` counts kernel launches: two a call with clipping, one
without. Both versions return ``s`` as a float32 tensor on the
parameters' device. Given the same ``s`` (``scale=``), the plain version
updates bit for bit as the kernel does; the sum of squares is taken in
another order, so ``s`` itself agrees to float32 rounding.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

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


def clip_momentum_sgd_ref(params: Sequence[torch.Tensor],
                          momentum: Sequence[torch.Tensor],
                          grads: Sequence[torch.Tensor], lr: float,
                          clip_norm: Optional[float] = 1.0, *,
                          scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version of the update kernels (any device), in the
    reference's order: the leaves' sums of squares added in the order
    given (the reference's ``tree_leaves`` order is the sorted names).
    ``scale``, if given, is used as ``s`` instead of computing it."""
    grads = list(grads)
    device = grads[0].device if grads else torch.device("cpu")
    if scale is not None:
        s = scale.reshape(())
    elif clip_norm is None:
        s = torch.ones((), dtype=_F32, device=device)
    else:
        total = torch.zeros((), dtype=_F32, device=device)
        for g in grads:
            total = total + torch.sum(torch.square(g))
        s = torch.clamp(clip_norm * torch.rsqrt(total + 1e-12), max=1.0)
    for p, m, g in zip(params, momentum, grads, strict=True):
        m.mul_(MOMENTUM)
        m.add_(g * s)  # s = 1 multiplies exactly
        p.sub_(lr * m)
    return s


def prepare_clip_momentum_sgd(params: Sequence[torch.Tensor],
                              momentum: Sequence[torch.Tensor],
                              grads: Sequence[torch.Tensor], lr: float,
                              clip_norm: Optional[float] = 1.0):
    """Check the update's CUDA tensors and bind its launches: ``(scale,
    [launch, ...])``, the sum-of-squares launch first when clipping."""
    params, momentum, grads = list(params), list(momentum), list(grads)
    if not (len(params) == len(momentum) == len(grads)) or not params:
        raise ValueError("clip_momentum_sgd: params, momentum and grads "
                         "must be non-empty and of one length")
    device = params[0].device
    if device.type != "cuda":
        raise ValueError(f"clip_momentum_sgd: no kernel for device {device}")
    for i, (p, m, g) in enumerate(zip(params, momentum, grads)):
        for name, t in (("param", p), ("momentum", m), ("grad", g)):
            build.check(f"{name} {i}", t, _F32, p.dim(), device)
        build.check_shape(f"momentum {i}", m, tuple(p.shape))
        build.check_shape(f"grad {i}", g, tuple(p.shape))
        if p.numel() == 0:
            raise ValueError(f"clip_momentum_sgd: param {i} is empty")
    lib = library()
    count = len(params)
    if count > lib.chana_update_max_tensors():
        raise ValueError(f"clip_momentum_sgd: {count} tensors; the kernel "
                         f"takes up to {lib.chana_update_max_tensors()}")
    ptrs = ctypes.c_void_p * count
    p_arr = ptrs(*(t.data_ptr() for t in params))
    m_arr = ptrs(*(t.data_ptr() for t in momentum))
    g_arr = ptrs(*(t.data_ptr() for t in grads))
    n_arr = (ctypes.c_longlong * count)(*(t.numel() for t in params))
    blocks = lib.chana_update_blocks(n_arr, count)
    if blocks <= 0:
        raise ValueError("clip_momentum_sgd: the kernel refuses these sizes")
    sq = torch.zeros(1, dtype=_F32, device=device)
    scale = torch.empty(1, dtype=_F32, device=device)
    launches = []
    if clip_norm is not None:
        partial = torch.empty(blocks, dtype=_F32, device=device)
        counter = torch.zeros(1, dtype=torch.int32, device=device)
        launches.append(build.launcher(
            lib, lib.chana_sumsq, "clip_momentum_sgd (sum of squares)",
            device, g_arr, n_arr, count, partial.data_ptr(), sq.data_ptr(),
            counter.data_ptr()))
    launches.append(build.launcher(
        lib, lib.chana_momentum_sgd, "clip_momentum_sgd (update)", device,
        p_arr, m_arr, g_arr, n_arr, count, sq.data_ptr(), scale.data_ptr(),
        1.0 if clip_norm is None else float(clip_norm),
        int(clip_norm is not None), float(lr), MOMENTUM))
    return scale.reshape(()), launches


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
