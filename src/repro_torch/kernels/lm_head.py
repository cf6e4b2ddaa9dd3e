"""Hopper CUDA kernels for the LM head's three products: the float32 logits
of bfloat16 activations and head, and their two gradients.

The model's head is ``x.to(float32) @ head.to(float32)`` for a bfloat16 x
(the final norm's output) and head (``models/model.py``, ``_logits``),
three float32 GEMMs with autograd, which a float32 product runs on the
card's CUDA cores.  The kernels (``csrc/lm_head.cu``) form the same
float32 products on the tensor cores: the forward is one bfloat16 pass
with float32 accumulation (a product of two bf16 values is exact in
float32), and each backward product splits the float32 ``dlogits`` into
three bfloat16 pieces whose sum is the value exactly, three passes with
exact products and float32 sums, rounded once to the bf16 gradient as the
float32 path's cast did.  They replace no Pallas kernel: the JAX package
leaves the head to XLA's einsum.  Bound: operations, three products of
2*T*d*V at 989 TFLOP/s; the algorithm's floor is 7 bf16 passes of it, the
backward's split being the cost of float32's precision.

The differentiable head is ``ops.lm_head`` (``ops._LMHead``): its forward
launches :func:`_lm_head_fwd`, its backward :func:`_lm_head_dx` and
:func:`_lm_head_dw`, each inside the program span ``repro_torch.lm_head``
(the forward's on the thread that runs the model, the backward's on
autograd's device thread); it saves x and the head as they are, bf16.
Each entry here takes the plain version in :mod:`.ref` for CPU tensors and
launches its kernel, or raises, for CUDA ones.  They are private, as the
attention backward's is: the JAX package's ops have no head to name.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _cuda_build
from .ref import lm_head_dw_ref, lm_head_dx_ref, lm_head_fwd_ref


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, n_int in (("lm_head_fwd_launch", 4), ("lm_head_dx_launch", 5),
                        ("lm_head_dw_launch", 4)):
        fn = getattr(lib, name)
        fn.argtypes = [p] * 3 + [i] * n_int + [p]
        fn.restype = ctypes.c_int
    lib.lm_head_error.argtypes = [ctypes.c_int]
    lib.lm_head_error.restype = ctypes.c_char_p
    return lib


def _operand(t: torch.Tensor, mult: int) -> torch.Tensor:
    """Contiguous ``t`` (rows, n) as the kernels read it: rows a multiple
    of ``mult`` values apart from a 16-byte boundary, as TMA reads them (a
    copy where t is not; where n is not such a multiple, a zero-padded
    one, the padding sliced off again)."""
    n = t.shape[-1]
    if n % mult == 0:
        return t if t.data_ptr() % 16 == 0 else t.clone()
    out = torch.zeros((t.shape[0], -(-n // mult) * mult), dtype=t.dtype,
                      device=t.device)
    out[:, :n] = t
    return out[:, :n]


def _check(kernel: str, device: torch.device, d: int, specs) -> None:
    """Raise ``ValueError`` unless the model width d is a multiple of 8 and
    every ``(name, tensor, dtype, shape)`` is a contiguous tensor of that
    dtype and shape on ``device``."""
    if d % 8:
        raise ValueError(f"{kernel}: the model width {d} is not a multiple "
                         "of 8")
    _cuda_build.check_tensors(kernel, device, specs)


def _launch(kernel: str, device: torch.device, fn: str, *args) -> None:
    with torch.cuda.device(device):
        lib = _cuda_build.load("lm_head", _bind)
        rc = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
        _cuda_build.check_launch(kernel, rc, lib.lm_head_error)


def _lm_head_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """logits (T, V) float32 = x (T, d) . w (d, V), both bfloat16.  CPU
    tensors take :func:`~repro_torch.kernels.ref.lm_head_fwd_ref`; CUDA
    tensors launch the kernel (contiguous, d a multiple of 8), or raise."""
    if not x.is_cuda:
        return lm_head_fwd_ref(x, w)
    (t, d), v = x.shape, w.shape[1]
    _check("lm_head_fwd", x.device, d, (("x", x, torch.bfloat16, (t, d)),
                                        ("w", w, torch.bfloat16, (d, v))))
    out = torch.empty((t, v), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    x, w = _operand(x, 8), _operand(w, 8)
    _launch("lm_head_fwd", x.device, "lm_head_fwd_launch", x.data_ptr(),
            w.data_ptr(), out.data_ptr(), t, d, v, w.stride(0))
    _lm_head_fwd.launches += 1
    return out


_lm_head_fwd.launches = 0


def _lm_head_dx(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx (T, d) bfloat16 = g (T, V) float32 . w (d, V)^T, rounded once.
    CPU tensors take :func:`~repro_torch.kernels.ref.lm_head_dx_ref`; CUDA
    tensors launch the kernel, or raise."""
    if not g.is_cuda:
        return lm_head_dx_ref(g, w)
    (t, v), d = g.shape, w.shape[0]
    _check("lm_head_dx", g.device, d, (("g", g, torch.float32, (t, v)),
                                       ("w", w, torch.bfloat16, (d, v))))
    out = torch.empty((t, d), dtype=torch.bfloat16, device=g.device)
    if out.numel() == 0:
        return out
    g, w = _operand(g, 4), _operand(w, 8)
    _launch("lm_head_dx", g.device, "lm_head_dx_launch", g.data_ptr(),
            w.data_ptr(), out.data_ptr(), t, d, v, g.stride(0), w.stride(0))
    _lm_head_dx.launches += 1
    return out


_lm_head_dx.launches = 0


def _lm_head_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dw (d, V) bfloat16 = x (T, d)^T . g (T, V), x bfloat16 and g
    float32, rounded once.  CPU tensors take
    :func:`~repro_torch.kernels.ref.lm_head_dw_ref`; CUDA tensors launch
    the kernel, or raise."""
    if not g.is_cuda:
        return lm_head_dw_ref(x, g)
    (t, d), v = x.shape, g.shape[1]
    _check("lm_head_dw", g.device, d, (("x", x, torch.bfloat16, (t, d)),
                                       ("g", g, torch.float32, (t, v))))
    out = torch.empty((d, v), dtype=torch.bfloat16, device=g.device)
    if out.numel() == 0:
        return out
    x, g = _operand(x, 8), _operand(g, 4)
    _launch("lm_head_dw", g.device, "lm_head_dw_launch", x.data_ptr(),
            g.data_ptr(), out.data_ptr(), t, d, v, g.stride(0))
    _lm_head_dw.launches += 1
    return out


_lm_head_dw.launches = 0
