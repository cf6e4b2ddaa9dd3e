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
is masked in the kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import _cuda_build
from .ref import attention_ref

_HEAD_DIMS = (64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_error.argtypes = [ctypes.c_int]
    lib.flash_attention_error.restype = ctypes.c_char_p
    return lib


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention (B,H,S,D) x (B,Hkv,S,D)^2 -> (B,H,S,D) in q's dtype.

    q head h reads kv head h // (H // Hkv); ``window`` > 0 keeps keys with
    q_pos - k_pos < window; ``sm_scale`` defaults to 1/sqrt(D).  CPU
    tensors take the plain PyTorch version
    (:func:`~repro_torch.kernels.ref.attention_ref`); CUDA tensors launch
    the kernel (float32 or bfloat16, D in 64/128/256, one S for q and kv;
    a bfloat16 view off a 16-byte boundary is copied first), or raise."""
    if not q.is_cuda:
        return attention_ref(q, k, v, causal=causal, window=window,
                             sm_scale=sm_scale)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention_fwd: q and k must be 4-d, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention_fwd: dtype {q.dtype} is not "
                         "float32 or bfloat16")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head dim {d} is not one of "
                         f"{_HEAD_DIMS}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"flash_attention_fwd: {h} q heads are not a "
                         f"multiple of {hkv} kv heads")
    _cuda_build.check_tensors("flash_attention_fwd", q.device, (
        ("q", q, q.dtype, (b, h, s, d)),
        ("k", k, q.dtype, (b, hkv, s, d)),
        ("v", v, q.dtype, (b, hkv, s, d))))
    if q.dtype == torch.bfloat16:
        # TMA reads from 16-byte boundaries: a view off one is copied first
        q, k, v = (t.clone() if t.data_ptr() % 16 else t for t in (q, k, v))
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    with torch.cuda.device(q.device):
        lib = _cuda_build.load("flash_attention", _bind)
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, hkv, s, d, int(q.dtype == torch.bfloat16), int(causal),
            int(window), float(scale),
            torch.cuda.current_stream().cuda_stream)
        _cuda_build.check_launch("flash_attention_fwd", rc,
                                 lib.flash_attention_error)
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
