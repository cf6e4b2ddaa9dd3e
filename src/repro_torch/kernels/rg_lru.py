"""Hopper CUDA kernel for the RG-LRU linear recurrence (Griffin).

Replaces the Pallas TPU kernel ``src/repro/kernels/rg_lru.py``
(``_rg_lru_kernel``, launched by ``rg_lru_pallas``).  The port's griffin
prefill runs it once per RG-LRU sublayer (``models/recurrent.rg_lru_scan``),
where the JAX package computes the same recurrence with
``lax.associative_scan`` in XLA.

What bounds it on the H100 is bytes: a and x read once, y written once,
3*B*S*W*4 bytes, about 0.15 ms at 3.35 TB/s for one serving launch (4, 4064,
2560).  The source (``csrc/rg_lru.cu``) runs one thread per (b, w) column
down the whole sequence, one warp of 32 columns per block (320 blocks at
the serving shape, over all 132 SMs), with 64-step tiles of a and x staged
by ``cp.async`` through a 3-stage shared-memory ring; its multiply and add
are rounded apart, so it matches the plain loop bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _cuda_build
from .ref import rg_lru_ref


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.rg_lru_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.rg_lru_error.argtypes = [ctypes.c_int]
    lib.rg_lru_error.restype = ctypes.c_char_p
    return lib


def rg_lru_pallas(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y_t = a_t * y_{t-1} + x_t along S from a zero state, (B, S, W).

    CPU tensors take the plain PyTorch version
    (:func:`~repro_torch.kernels.ref.rg_lru_ref`); CUDA tensors launch the
    kernel (float32, contiguous), or raise."""
    if not x.is_cuda:
        return rg_lru_ref(a, x)
    if x.dim() != 3:
        raise ValueError(f"rg_lru_pallas: x must be (B, S, W), got "
                         f"{tuple(x.shape)}")
    b, s, w = x.shape
    if b > 65535:
        raise ValueError(f"rg_lru_pallas: batch {b} exceeds 65535")
    _cuda_build.check_tensors("rg_lru_pallas", x.device, (
        ("a", a, torch.float32, (b, s, w)),
        ("x", x, torch.float32, (b, s, w))))
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        lib = _cuda_build.load("rg_lru", _bind)
        rc = lib.rg_lru_launch(a.data_ptr(), x.data_ptr(), out.data_ptr(),
                               b, s, w,
                               torch.cuda.current_stream().cuda_stream)
        _cuda_build.check_launch("rg_lru_pallas", rc, lib.rg_lru_error)
    rg_lru_pallas.launches += 1
    return out


rg_lru_pallas.launches = 0
