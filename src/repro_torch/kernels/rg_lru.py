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

Training needs the recurrence's gradient, which the TPU reference leaves to
XLA's autodiff of ``associative_scan``: the adjoint is the same recurrence
run backward in time, so it is a second kernel of the same source
(``rg_lru_bwd_kernel``), launched by the private ``_rg_lru_pallas_bwd``
behind ``ops.rg_lru_bwd``; its plain version is
:func:`~repro_torch.kernels.ref.rg_lru_bwd_ref`.  It reads g, a and y once
and writes dx and da once, 5*B*S*W*4 bytes (about 63 us for one training
launch (1, 4096, 2560) at 3.35 TB/s), and matches autograd through the
plain loop bit for bit.  Each column stays one sequential walk, so its
blocks are 16 columns wide (160 at the training shape, over all 132 SMs):
a memory warp moves 64-step tiles by TMA through a 4-stage shared-memory
ring and a walker warp runs only the chain.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _cuda_build
from .ref import rg_lru_bwd_ref, rg_lru_ref


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.rg_lru_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bwd = lib.rg_lru_bwd_launch
    bwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    lib.rg_lru_error.argtypes = [ctypes.c_int]
    lib.rg_lru_error.restype = ctypes.c_char_p
    return lib


# Shape-only forms of the recurrence and its adjoint for meta tensors (the
# dry run's): one op each, reading the inputs and writing the outputs
# once, as the kernels do, where the plain versions would loop over time.
_meta_lib = torch.library.Library("repro_torch", "DEF")
_meta_lib.define("rg_lru_scan(Tensor a, Tensor x) -> Tensor")
_meta_lib.define(
    "rg_lru_scan_bwd(Tensor a, Tensor y, Tensor g) -> (Tensor, Tensor)")
_meta_lib.impl("rg_lru_scan", lambda a, x: torch.empty_like(x), "Meta")
_meta_lib.impl("rg_lru_scan_bwd", lambda a, y, g: (
    torch.empty_like(g, dtype=torch.float32),
    torch.empty_like(g, dtype=torch.float32)), "Meta")


def rg_lru_pallas(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y_t = a_t * y_{t-1} + x_t along S from a zero state, (B, S, W).

    CPU tensors take the plain PyTorch version
    (:func:`~repro_torch.kernels.ref.rg_lru_ref`); CUDA tensors launch the
    kernel (float32, contiguous), or raise; meta tensors give the shape."""
    if x.device.type == "meta":
        return torch.ops.repro_torch.rg_lru_scan(a, x)
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


def _rg_lru_pallas_bwd(a: torch.Tensor, y: torch.Tensor, g: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(da, dx) of ``y = rg_lru_pallas(a, x)`` for upstream gradient ``g``,
    all (B, S, W).

    CPU tensors take the plain reverse loop (:func:`rg_lru_bwd_ref`); CUDA
    tensors launch the backward kernel (float32, contiguous), or raise."""
    if g.device.type == "meta":
        return torch.ops.repro_torch.rg_lru_scan_bwd(a, y, g)
    if not g.is_cuda:
        return rg_lru_bwd_ref(a, y, g)
    if g.dim() != 3:
        raise ValueError(f"rg_lru backward: g must be (B, S, W), got "
                         f"{tuple(g.shape)}")
    b, s, w = g.shape
    if b > 65535:
        raise ValueError(f"rg_lru backward: batch {b} exceeds 65535")
    _cuda_build.check_tensors("rg_lru backward", g.device, (
        ("a", a, torch.float32, (b, s, w)),
        ("y", y, torch.float32, (b, s, w)),
        ("g", g, torch.float32, (b, s, w))))
    da = torch.empty_like(g)
    dx = torch.empty_like(g)
    if g.numel() == 0:
        return da, dx
    with torch.cuda.device(g.device):
        lib = _cuda_build.load("rg_lru", _bind)
        rc = lib.rg_lru_bwd_launch(a.data_ptr(), y.data_ptr(), g.data_ptr(),
                                   da.data_ptr(), dx.data_ptr(), b, s, w,
                                   torch.cuda.current_stream().cuda_stream)
        _cuda_build.check_launch("rg_lru backward", rc, lib.rg_lru_error)
    _rg_lru_pallas_bwd.launches += 1
    return da, dx


_rg_lru_pallas_bwd.launches = 0
