"""Hopper CUDA kernel for the attention forward pass: causal, sliding window
or bidirectional, GQA.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``_flash_fwd_kernel``, launched by ``flash_attention_fwd``).  The port
runs it once per attention layer of a fresh prompt over the prompt's own
keys (``models/layers.attention_layer``: the dense prefill and training
forward, the griffin prefill's local-attention layers), where the JAX
package computes the same function with ``layers.chunked_attention`` in
XLA.

What bounds it on the H100 is operations: 4*D per unmasked (q, k) pair,
about 0.26 ms at the 989 TFLOP/s bf16 tensor-core peak for one griffin
serving launch (B=4, H=10, S=4064, D=256, window 2048) and 0.55 ms for a
Llama-3-8B prefill launch (B=4, H=32, S=4064, D=128, causal).  The source
(``csrc/flash_attention.cu``) holds three designs, picked by dtype and
head dim.  bfloat16 runs on the tensor cores (``wgmma``; q, k and v tiles
brought into shared memory by TMA; online softmax and O in registers; 128
q rows a block, the longest q tiles first).  At D = 64 and 128 a producer
warpgroup streams 128-key k and v tiles through a ring of shared-memory
stages, and each of two consumer warpgroups issues a tile's Q.K^T
together with the previous tile's P.V and runs the tile's softmax while
that P.V runs; named barriers make the two take turns to issue.  With
12 warps a thread may hold 168 registers, so at D = 128 P goes through
shared memory; at D = 64 it stays in registers.  D = 256 keeps two
warpgroups and 64-key tiles fed by one of their threads: its O
accumulator leaves no registers for a third warpgroup.
float32 keeps the CUDA-core body (TF32 would break its 2e-5 tolerance).
Tiles wholly masked are never loaded; a ragged last tile reads zeros and
is masked in the kernel.  A training forward (``return_lse``) also writes
each row's logsumexp, float32 (B, H, S), for the backward.

Training needs attention's gradient, which the TPU reference recomputes
through ``attention_ref`` (``_fa_bwd``): here it is a second source,
``csrc/flash_attention_bwd.cu``, launched by the private
``_flash_attention_bwd`` behind ``ops.flash_attention_bwd``; its plain
version is :func:`~repro_torch.kernels.ref.flash_attention_bwd_ref`.  It
rebuilds P from the saved ``lse`` tile by tile and never holds an (S, S)
tensor: a dK/dV pass with the key tile outside (each block walks the q
heads of its group, or its share of them, and the q tiles that see its
keys, in a fixed order) and a dQ pass with the q tile outside, no
atomics, so two calls agree bit for bit.  Bound: operations, 10*D per
unmasked pair, 0.348 ms for one Llama-3-8B training launch (1, 32 over 8,
4096, 128, causal) at 989 TFLOP/s.  bfloat16 runs on the tensor cores
(``wgmma``; TMA loads through an mbarrier ring; S^T and dP^T computed so
that P^T and dS^T are the register operands of dV and dK); where a batch's
kv heads and key tiles give fewer dK/dV blocks than the card has SMs,
:func:`_bwd_head_split` splits each group's q heads over blocks, whose
float32 partial dK and dV a fourth kernel sums in head order.  float32
runs on the CUDA cores.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .. import _cuda_build
from .ref import attention_ref, flash_attention_bwd_ref

_HEAD_DIMS = (64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)


def _bind_serving(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The serving entry (no lse) and the error string."""
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_error.argtypes = [ctypes.c_int]
    lib.flash_attention_error.restype = ctypes.c_char_p
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = _bind_serving(lib).flash_attention_lse_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                   + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_bwd_scratch_floats.argtypes = [ctypes.c_int] * 7
    lib.flash_attention_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.flash_attention_bwd_error.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error.restype = ctypes.c_char_p
    return lib


def _bwd_head_split(b: int, h: int, hkv: int, s: int, d: int, bf16: bool,
                    n_sm: int) -> int:
    """Over how many blocks the backward's dK/dV pass splits each group's
    q heads: 1 unless the bf16 pass would have fewer blocks (one per batch,
    kv head and key tile: 128 keys, 64 at D=256) than the card has SMs,
    else enough parts for about two blocks an SM, at most one a q head.
    Each part's float32 partial dK and dV are then summed in head order by
    a fourth kernel."""
    if not bf16:
        return 1
    keys = 64 if d == 256 else 128
    blocks = b * hkv * -(-s // keys)
    if blocks >= n_sm:
        return 1
    return min(h // hkv, -(-2 * n_sm // blocks))


def _check(kernel: str, q: torch.Tensor, k: torch.Tensor
           ) -> Tuple[int, int, int, int, int]:
    """(B, H, Hkv, S, D) of a launch the kernels take, or raise."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{kernel}: q and k must be 4-d, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if q.dtype not in _DTYPES:
        raise ValueError(f"{kernel}: dtype {q.dtype} is not float32 or "
                         "bfloat16")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{kernel}: head dim {d} is not one of "
                         f"{_HEAD_DIMS}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"{kernel}: {h} q heads are not a multiple of "
                         f"{hkv} kv heads")
    return b, h, hkv, s, d


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        sm_scale: Optional[float] = None,
                        return_lse: bool = False):
    """Attention (B,H,S,D) x (B,Hkv,S,D)^2 -> (B,H,S,D) in q's dtype.

    q head h reads kv head h // (H // Hkv); ``window`` > 0 keeps keys with
    q_pos - k_pos < window; ``sm_scale`` defaults to 1/sqrt(D).  With
    ``return_lse`` it returns ``(out, lse)``, lse each row's logsumexp of
    its masked, scaled scores, float32 (B, H, S).  CPU tensors take the
    plain PyTorch version (:func:`~repro_torch.kernels.ref.attention_ref`);
    CUDA tensors launch the kernel (float32 or bfloat16, D in 64/128/256,
    one S for q and kv; a bfloat16 view off a 16-byte boundary is copied
    first), or raise."""
    if not q.is_cuda:
        return attention_ref(q, k, v, causal=causal, window=window,
                             sm_scale=sm_scale, return_lse=return_lse)
    b, h, hkv, s, d = _check("flash_attention_fwd", q, k)
    _cuda_build.check_tensors("flash_attention_fwd", q.device, (
        ("q", q, q.dtype, (b, h, s, d)),
        ("k", k, q.dtype, (b, hkv, s, d)),
        ("v", v, q.dtype, (b, hkv, s, d))))
    if q.dtype == torch.bfloat16:
        # TMA reads from 16-byte boundaries: a view off one is copied first
        q, k, v = (t.clone() if t.data_ptr() % 16 else t for t in (q, k, v))
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.numel() == 0:
        return (out, lse) if return_lse else out
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    args = (b, h, hkv, s, d, int(q.dtype == torch.bfloat16), int(causal),
            int(window), float(scale), torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(q.device):
        lib = _cuda_build.load("flash_attention", _bind)
        if return_lse:
            rc = lib.flash_attention_lse_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), *args)
        else:
            rc = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *args)
        _cuda_build.check_launch("flash_attention_fwd", rc,
                                 lib.flash_attention_error)
    flash_attention_fwd.launches += 1
    return (out, lse) if return_lse else out


flash_attention_fwd.launches = 0


def _flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                         causal: bool = True, window: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``o = flash_attention_fwd(q, k, v)`` for upstream
    gradient ``do`` (like o), from o and the forward's ``lse``, each in
    its input's shape and dtype.

    CPU tensors take the plain formulas
    (:func:`~repro_torch.kernels.ref.flash_attention_bwd_ref`); CUDA
    tensors launch the backward kernels (float32 or bfloat16, D in
    64/128/256, contiguous; a view off a 16-byte boundary is copied
    first), or raise."""
    if not q.is_cuda:
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window)
    b, h, hkv, s, d = _check("flash attention backward", q, k)
    _cuda_build.check_tensors("flash attention backward", q.device, (
        ("q", q, q.dtype, (b, h, s, d)),
        ("k", k, q.dtype, (b, hkv, s, d)),
        ("v", v, q.dtype, (b, hkv, s, d)),
        ("o", o, q.dtype, (b, h, s, d)),
        ("lse", lse, torch.float32, (b, h, s)),
        ("do", do, q.dtype, (b, h, s, d))))
    # 16-byte copies (TMA, cp.async, vector loads): a view off a 16-byte
    # boundary is copied first
    q, k, v, o, do = (t.clone() if t.data_ptr() % 16 else t
                      for t in (q, k, v, o, do))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    bf16 = q.dtype == torch.bfloat16
    split = _bwd_head_split(
        b, h, hkv, s, d, bf16,
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    with torch.cuda.device(q.device):
        lib = _cuda_build.load("flash_attention_bwd", _bind_bwd)
        n_scratch = lib.flash_attention_bwd_scratch_floats(
            b, h, hkv, s, d, int(bf16), split)
        # delta and the row statistics, and the split's partial dK and dV
        scratch = torch.empty(n_scratch, dtype=torch.float32,
                              device=q.device)
        rc = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, hkv, s, d, int(bf16),
            int(causal), int(window), split, n_scratch, 1.0 / math.sqrt(d),
            torch.cuda.current_stream().cuda_stream)
        _cuda_build.check_launch("flash attention backward", rc,
                                 lib.flash_attention_bwd_error)
    _flash_attention_bwd.launches += 1
    return dq, dk, dv


_flash_attention_bwd.launches = 0
