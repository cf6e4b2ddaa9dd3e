"""Public entry points of the port's kernels, with device dispatch.

The model ops (``flash_attention`` and its gradient
``flash_attention_bwd``, ``rg_lru`` and its gradient ``rg_lru_bwd``, and
``lm_head``, the LM head's float32 logits of bf16 operands with their
gradients) take tensors and dispatch on their device: the kernel on a
CUDA device (or raise), the plain version from :mod:`ref` on the CPU.
Each Metronome op takes host arrays (any float dtype; ``core`` builds
float64), casts them to the kernels' types here — float32, and uint8 for
the 0/1 route matrix — copies them to ``device`` once, and dispatches on
the tensors' device: on a CUDA device the hand-written kernel runs (or
raises), on the CPU its plain PyTorch version from :mod:`ref`.  Results
come back as numpy float32 arrays, as the JAX package's ops return them.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from .. import _device
from .._spans import span
from . import ref
from .flash_attention import _flash_attention_bwd, flash_attention_fwd
from .lm_head import _lm_head_dw, _lm_head_dx, _lm_head_fwd
from .metronome_fill import metronome_fill
from .metronome_score import (metronome_score_multilink,
                              metronome_score_multilink_batch,
                              metronome_score_pairwise)
from .rg_lru import _rg_lru_pallas_bwd, rg_lru_pallas

Device = Union[str, torch.device]


def _to(x, dtype: np.dtype, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(dev)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


# ---------------------------------------------------------------------------
# the LM head
# ---------------------------------------------------------------------------

LM_HEAD_SPAN = "repro_torch.lm_head"


class _LMHead(torch.autograd.Function):
    """logits (..., V) float32 of x (..., d) and the head w (d, V), both
    bfloat16, by the head's kernels; the backward's two products by the
    kernels too.  It saves x and w as they are, bf16 (w made contiguous
    first, a copy only where it is not)."""

    @staticmethod
    def forward(ctx, x, w):
        w = w.contiguous()
        ctx.save_for_backward(x, w)
        with span(LM_HEAD_SPAN):
            out = _lm_head_fwd(x.reshape(-1, x.shape[-1]), w)
        return out.view(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.reshape(-1, w.shape[1]).contiguous()
        dx = dw = None
        with span(LM_HEAD_SPAN):
            if ctx.needs_input_grad[0]:
                dx = _lm_head_dx(g, w).view(x.shape)
            if ctx.needs_input_grad[1]:
                dw = _lm_head_dw(x.reshape(-1, x.shape[-1]), g)
        return dx, dw


def lm_head(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x.float() @ w.float()`` for bfloat16 x (..., d) and w (d, V):
    float32 logits (..., V), differentiable, the bf16 gradients rounded
    once from float32 sums.  CPU tensors take the plain versions
    (``ref.lm_head_*_ref``), CUDA tensors the kernels."""
    return _LMHead.apply(x, w)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """The kernel forward, which also keeps each row's logsumexp where a
    gradient is wanted; the backward is :func:`flash_attention_bwd` (the
    JAX package's ``_fa_bwd`` recomputes through ``attention_ref``: the
    same function)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.causal, ctx.window = causal, window
        if not any(ctx.needs_input_grad[:3]):  # serving: no lse
            return flash_attention_fwd(q, k, v, causal=causal, window=window)
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, o, lse, g, ctx.causal,
                                     ctx.window), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """(B,H,S,D) x (B,Hkv,S,D)^2 -> (B,H,S,D), differentiable."""
    return _FlashAttention.apply(q, k, v, causal, window)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True, window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``o = flash_attention(q, k, v, causal, window)`` for
    upstream gradient ``do``, from o and the forward's row logsumexp
    ``lse``: the backward kernel on a CUDA device,
    :func:`ref.flash_attention_bwd_ref` on the CPU.  Strided inputs are
    copied to contiguous ones first."""
    return _flash_attention_bwd(
        *(t.contiguous() for t in (q, k, v, o, lse, do)), causal, window)


# ---------------------------------------------------------------------------
# metronome rotation scoring
# ---------------------------------------------------------------------------

def score_pairwise(base_demand, bank_a, bank_b, capacity: float,
                   device: Device = "cuda") -> np.ndarray:
    """Eq. 18 scores for every (rot_a, rot_b) pair; see core/rotation.py."""
    dev = _device.resolve(device)
    return _host(metronome_score_pairwise(
        _to(base_demand, np.float32, dev), _to(bank_a, np.float32, dev),
        _to(bank_b, np.float32, dev), float(capacity)))


def score_multilink(base_demand, bank_a, bank_b, capacities,
                    device: Device = "cuda") -> np.ndarray:
    """Joint (min-over-links) Eq. 18 scores for every rotation pair of two
    free jobs over stacked (L, R, S) per-link demand banks."""
    dev = _device.resolve(device)
    return _host(metronome_score_multilink(
        _to(base_demand, np.float32, dev), _to(bank_a, np.float32, dev),
        _to(bank_b, np.float32, dev), _to(capacities, np.float32, dev)))


def score_multilink_batch(base_demand, bank_a, bank_b, capacities,
                          device: Device = "cuda") -> np.ndarray:
    """Candidate-batched joint Eq. 18 scores: ONE launch over stacked
    (C, L, R, S) banks returning (C, Ra, Rb) — the Score phase's surviving
    candidates evaluated together."""
    dev = _device.resolve(device)
    return _host(metronome_score_multilink_batch(
        _to(base_demand, np.float32, dev), _to(bank_a, np.float32, dev),
        _to(bank_b, np.float32, dev), _to(capacities, np.float32, dev)))


# ---------------------------------------------------------------------------
# progressive-filling fluid solve
# ---------------------------------------------------------------------------

def progressive_fill_ref(demands, routes, caps,
                         device: Device = "cuda") -> np.ndarray:
    """The plain PyTorch fill on ``device`` — the fluid engine's
    ``backend='torch'`` path, never the kernel."""
    dev = _device.resolve(device)
    return _host(ref.progressive_fill_ref(
        _to(demands, np.float32, dev), _to(routes, np.uint8, dev),
        _to(caps, np.float32, dev)))


def progressive_fill(demands, routes, caps,
                     device: Device = "cuda") -> np.ndarray:
    """Batched progressive-fill rates (B, F) over (B, F, L) route matrices:
    the fill kernel on a CUDA device, its plain version on the CPU."""
    dev = _device.resolve(device)
    return _host(metronome_fill(
        _to(demands, np.float32, dev), _to(routes, np.uint8, dev),
        _to(caps, np.float32, dev)))


# ---------------------------------------------------------------------------
# rg-lru recurrence
# ---------------------------------------------------------------------------

class _RgLru(torch.autograd.Function):
    """The forward kernel; the backward is the adjoint recurrence
    (:func:`rg_lru_bwd`), from the saved gates and output."""

    @staticmethod
    def forward(ctx, a, x):
        y = rg_lru_pallas(a, x)
        ctx.save_for_backward(a, y)
        return y

    @staticmethod
    def backward(ctx, g):
        a, y = ctx.saved_tensors
        return rg_lru_bwd(a, y, g)


def rg_lru(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y_t = a_t * y_{t-1} + x_t along S from a zero state, (B, S, W),
    differentiable in ``a`` and ``x``."""
    return _RgLru.apply(a, x)


def rg_lru_bwd(a: torch.Tensor, y: torch.Tensor, g: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(da, dx) of ``y = rg_lru(a, x)`` for upstream gradient ``g``: the
    backward kernel on a CUDA device, :func:`ref.rg_lru_bwd_ref` on the
    CPU.  Strided inputs are copied to contiguous ones first."""
    return _rg_lru_pallas_bwd(a.contiguous(), y.contiguous(), g.contiguous())
