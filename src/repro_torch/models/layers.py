"""Core layers: norms, RoPE/M-RoPE, chunked (flash-style) attention, MLP.

Plain PyTorch, the JAX package's ``models/layers.py`` op for op.  Parameters
are nested dicts of tensors; each ``init_*`` draws from an explicit
``torch.Generator`` on the generator's device and returns the params (the
port runs on one card, so there are no logical sharding specs).

``attention_layer`` sends a fresh prompt on a CUDA device through the flash
kernel (``kernels.ops.flash_attention``); every other call, and every call
on the CPU, runs the plain :func:`chunked_attention`, as the JAX package
does everywhere.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig

NEG_INF = -1e30

Index = Union[int, torch.Tensor]


def truncated_normal(generator: torch.Generator, shape: Tuple[int, ...],
                     dtype: torch.dtype, std: float) -> torch.Tensor:
    """``std`` times a standard normal truncated to [-2, 2], drawn in float32
    on the generator's device and cast to ``dtype``."""
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(std).to(dtype)


class _GradBf16Barrier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16)


def grad_bf16_barrier(x: torch.Tensor) -> torch.Tensor:
    """Identity with a bf16 cotangent cast.

    The f32 logits/loss head makes every residual-stream cotangent f32;
    casting the cotangent back to bf16 at block boundaries keeps the
    backward collectives in bf16 -- the standard mixed-precision training
    contract.  Wired into the dense family's blocks under
    ``cfg.bf16_grad_barrier``, as in the JAX package."""
    return _GradBf16Barrier.apply(x)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype: torch.dtype,
                 device: Optional[torch.device] = None) -> Dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: Dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def init_layernorm(d: int, dtype: torch.dtype,
                   device: Optional[torch.device] = None) -> Dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params: Dict, x: torch.Tensor, eps: float = 1e-6
              ) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    sin, cos = angles.sin()[..., None, :], angles.cos()[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (D/2,)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    positions: (3, B, S) — temporal / height / width position streams.
    sections: per-stream number of (pair) frequencies, summing to D/2.
    """
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"mrope sections {sections} do not sum to {d // 2}")
    freqs = rope_freqs(d, theta, x.device)
    sec_id = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.tensor(sections, device=x.device))  # (D/2,)
    # angles[b, s, f] = positions[sec_id[f], b, s] * freqs[f]
    onehot = F.one_hot(sec_id, len(sections)).float().T * freqs[None, :]
    angles = torch.einsum("tbs,tf->bsf", positions.float(), onehot)
    return _rotate(x, angles)


# ---------------------------------------------------------------------------
# Attention (chunked online-softmax; GQA grouped; causal / window / bidir)
# ---------------------------------------------------------------------------

def chunked_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, Kv, D)
    v: torch.Tensor,  # (B, Sk, Kv, D)
    *,
    causal: bool,
    q_offset: Any = 0,  # scalar or (B,) start position of q within kv timeline
    window: int = 0,
    kv_len: Optional[torch.Tensor] = None,  # (B,) valid kv length (decode)
    chunk: int = 1024,
) -> torch.Tensor:
    """Flash-style attention: a loop over KV chunks with online softmax.

    Peak memory is O(Sq * chunk) per head group instead of O(Sq * Sk).  The
    flash kernel (``kernels/flash_attention.py``) computes the same function
    for a fresh prompt on the card."""
    b, sq, h, d = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    g = h // n_kv
    qg = q.reshape(b, sq, n_kv, g, d).float()
    scale = 1.0 / math.sqrt(d)
    chunk = min(chunk, sk)
    if sk % chunk:
        raise ValueError(f"kv length {sk} is not a multiple of chunk {chunk}")

    dev = q.device
    q_pos = (torch.as_tensor(q_offset, device=dev)[..., None]
             + torch.arange(sq, device=dev)).expand(b, sq)
    m = torch.full((b, n_kv, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, n_kv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, n_kv, g, sq, d), dtype=torch.float32, device=dev)
    for c0 in range(0, sk, chunk):
        kb = k[:, c0:c0 + chunk].float()
        vb = v[:, c0:c0 + chunk].float()
        k_pos = c0 + torch.arange(chunk, device=dev)
        s = torch.einsum("bqkgd,bckd->bkgqc", qg, kb) * scale
        mask = torch.ones((b, sq, chunk), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos[:, :, None] >= k_pos[None, None, :]
        if window > 0:
            mask &= (q_pos[:, :, None] - k_pos[None, None, :]) < window
        if kv_len is not None:
            mask &= k_pos[None, None, :] < kv_len[:, None, None]
        s = torch.where(mask[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqc,bckd->bkgqd", p, vb)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    # (B, Kv, G, Sq, D) -> (B, Sq, H, D)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention layer (projections + rope + cache handling)
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, generator: torch.Generator,
                   d_model: Optional[int] = None, cross: bool = False
                   ) -> Dict:
    """Projections (and the qk-norm scales); a cross-attention layer
    (``cross``) has the same parameters, its keys and values projected from
    another sequence by ``attention_layer``'s ``kv_source``."""
    del cross
    d = d_model or cfg.d_model
    hd, h, kv = cfg.head_dim, cfg.n_heads, cfg.n_kv
    std = 0.02
    pd = cfg.param_dtype
    p = {
        "wq": truncated_normal(generator, (d, h * hd), pd, std),
        "wk": truncated_normal(generator, (d, kv * hd), pd, std),
        "wv": truncated_normal(generator, (d, kv * hd), pd, std),
        "wo": truncated_normal(generator, (h * hd, d), pd,
                               std / math.sqrt(2 * cfg.n_layers)),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, pd, generator.device)
        p["k_norm"] = init_rmsnorm(hd, pd, generator.device)
    return p


def _write(buf: torch.Tensor, new: torch.Tensor, index: Index) -> None:
    """``buf[:, index:index + S] = new`` along the sequence axis, in place."""
    new = new.to(buf.dtype)
    if isinstance(index, int):
        buf[:, index:index + new.shape[1]] = new
    else:
        rows = index + torch.arange(new.shape[1], device=buf.device)
        buf.index_copy_(1, rows.long(), new)


def attention_layer(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, D)
    *,
    positions: Optional[torch.Tensor] = None,  # (B,S) or (3,B,S) for mrope
    causal: bool = True,
    window: int = 0,
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (B,Smax,Kv,D) x2
    cache_index: Optional[Index] = None,  # current length
    kv_source: Optional[torch.Tensor] = None,  # cross attention source
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Projections, rotary embedding, the cache write and attention.

    The cache is written in place (the JAX package returns updated copies)
    and returned.  A fresh prompt (self-attention at default positions, no
    cache or a cache written from 0) on a CUDA device goes through the
    flash kernel over the prompt's own keys: with ``kv_len = S`` and
    ``q_offset = 0`` the cache slots at or past S are masked, so that is the
    function the chunked path computes over the whole cache."""
    b, s, _ = x.shape
    hd, h, n_kv = cfg.head_dim, cfg.n_heads, cfg.n_kv
    src = kv_source if kv_source is not None else x
    fresh = (kv_source is None and positions is None
             and (cache is None or (isinstance(cache_index, int)
                                    and cache_index == 0)))

    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (src @ p["wk"]).reshape(b, src.shape[1], n_kv, hd)
    v = (src @ p["wv"]).reshape(b, src.shape[1], n_kv, hd)

    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)

    if kv_source is None:  # self-attention: rotary embedding
        if positions is None:
            base = cache_index if cache_index is not None else 0
            positions = (torch.arange(s, device=x.device)[None, :]
                         + base).expand(b, s)
        if cfg.mrope_sections:
            if positions.dim() == 2:  # text-only fallback: same stream x3
                positions = positions[None].expand(3, *positions.shape)
            q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
            q_offset = positions[0, :, 0]
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
            q_offset = positions[:, 0]
    else:
        q_offset = torch.zeros((b,), dtype=torch.int32, device=x.device)

    new_cache = None
    kv_len = None
    if cache is not None:
        ck, cv = cache
        _write(ck, k, cache_index)
        _write(cv, v, cache_index)
        new_cache = (ck, cv)
        kv_len = torch.full((b,), 0, dtype=torch.int32,
                            device=x.device) + (cache_index + s)

    causal = causal and kv_source is None
    if fresh and q.is_cuda:
        if cache is not None:
            k, v = k.to(ck.dtype), v.to(cv.dtype)
        out = ops.flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal, window).transpose(1, 2)
    else:
        if cache is not None:
            k, v = new_cache
        out = chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                                window=window, kv_len=kv_len,
                                chunk=cfg.attn_chunk)
    out = out.reshape(b, s, h * hd) @ p["wo"]
    return out, new_cache


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, generator: torch.Generator,
             d_ff: Optional[int] = None) -> Dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    pd = cfg.param_dtype
    return {
        "w_gate": truncated_normal(generator, (d, f), pd, 0.02),
        "w_up": truncated_normal(generator, (d, f), pd, 0.02),
        "w_down": truncated_normal(generator, (f, d), pd,
                                   0.02 / math.sqrt(2 * cfg.n_layers)),
    }


def mlp(p: Dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]
