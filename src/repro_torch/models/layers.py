"""Core layers: norms, RoPE/M-RoPE, chunked (flash-style) attention, MLP.

Plain PyTorch, the JAX package's ``models/layers.py`` op for op.  Parameters
are nested dicts of tensors; each ``init_*`` draws from an explicit
``torch.Generator`` on the generator's device and returns the params, and
the matching ``*_specs`` gives their logical axes (the JAX init's second
return value).  ``logical_shard`` sits where the JAX package's does: it
redistributes DTensors under ``sharding.use_rules`` and leaves plain
tensors alone.

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
from torch.distributed.tensor import Partial, Replicate, Shard

from ..kernels import ops
from ..sharding import logical_shard
from ..sharding.local import is_dtensor, local_range, on_local, settled
from .config import ModelConfig, Yarn
from .remat import unbatched_product

NEG_INF = -1e30

Index = Union[int, torch.Tensor]


def truncated_normal(generator: torch.Generator, shape: Tuple[int, ...],
                     dtype: torch.dtype, std: float) -> torch.Tensor:
    """``std`` times a standard normal truncated to [-2, 2], drawn in float32
    on the generator's device and cast to ``dtype``; on the meta device
    (``models.abstract_params``) nothing is drawn."""
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
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


def norm_specs(bias: bool = False) -> Dict:
    """Logical axes of a norm's parameters (layernorm: ``bias``)."""
    return ({"scale": (None,), "bias": (None,)} if bias
            else {"scale": (None,)})


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

def _yarn_dim(rotations: float, head_dim: int, theta: float,
              original_max: int) -> float:
    """The dimension index whose wavelength turns ``rotations`` times over
    ``original_max`` positions (YaRN's ``find_correction_dim``)."""
    return (head_dim * math.log(original_max / (rotations * 2 * math.pi))
            / (2 * math.log(theta)))


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None,
               yarn: Optional[Yarn] = None) -> torch.Tensor:
    """The D/2 inverse wavelengths; with ``yarn``, those past the ramp
    from ``beta_fast`` to ``beta_slow`` rotations over ``original_max``
    positions divided by ``factor``, and a linear blend inside it
    (``transformers``' ``_compute_yarn_parameters``, in float64, rounded
    once to float32)."""
    if yarn is None:
        return 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32,
                                             device=device) / head_dim))
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float64,
                                        device=device) / head_dim))
    low = max(math.floor(_yarn_dim(yarn.beta_fast, head_dim, theta,
                                   yarn.original_max)), 0)
    high = min(math.ceil(_yarn_dim(yarn.beta_slow, head_dim, theta,
                                   yarn.original_max)), head_dim - 1)
    if low == high:
        high += 0.001
    i = torch.arange(head_dim // 2, dtype=torch.float64, device=device)
    ramp = ((i - low) / (high - low)).clamp(0.0, 1.0)
    return (inv / yarn.factor * ramp + inv * (1.0 - ramp)).float()


def _rotate(x: torch.Tensor, angles: torch.Tensor,
            scale: float = 1.0) -> torch.Tensor:
    sin, cos = angles.sin()[..., None, :], angles.cos()[..., None, :]
    if scale != 1.0:
        sin, cos = sin * scale, cos * scale
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               yarn: Optional[Yarn] = None) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).  With
    ``yarn``, its wavelengths and cos and sin times its
    ``attention_factor`` (so that q.k carries its square)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device, yarn)  # (D/2,)
    return _rotate(x, positions[..., None].float() * freqs,
                   yarn.attention_factor if yarn is not None else 1.0)


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
    with unbatched_product():  # a product without batch dims (remat "dots")
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


def attention_specs(cfg: ModelConfig) -> Dict:
    s = {"wq": ("w_embed", "w_heads"), "wk": ("w_embed", "w_heads"),
         "wv": ("w_embed", "w_heads"), "wo": ("w_heads", "w_embed")}
    if cfg.qk_norm:
        s["q_norm"], s["k_norm"] = norm_specs(), norm_specs()
    return s


def _write(buf: torch.Tensor, new: torch.Tensor, index: Index) -> None:
    """``buf[:, index:index + S] = new`` along the sequence axis, in place
    (on DTensors, in each rank's block: :func:`_write_local`)."""
    new = new.to(buf.dtype)
    if is_dtensor(buf):
        _write_local(buf, new, index)
    elif isinstance(index, int):
        buf[:, index:index + new.shape[1]] = new
    else:
        rows = index + torch.arange(new.shape[1], device=buf.device)
        buf.index_copy_(1, rows.long(), new)


def _write_local(buf, new, index: Index) -> None:
    """The cache write into a DTensor buffer (B, Smax, ...) whose sequence
    axis may be split over the mesh (the ``kv_seq`` layout): ``new`` takes
    the buffer's layout but whole along the sequence, and each rank writes
    the rows that fall in its block.  DTensor has no rule for an in-place
    write into a slice of a split dim."""
    mesh = buf.device_mesh
    want = [Replicate() if pl.is_shard() and pl.dim == 1 else pl
            for pl in buf.placements]
    new_l = new.redistribute(mesh, want).to_local()
    buf_l = buf.to_local()
    lo, length = local_range(buf, 1)
    if isinstance(index, int):  # the rows are known on the host
        a, b = max(index, lo), min(index + new_l.shape[1], lo + length)
        if a < b:
            buf_l[:, a - lo:b - lo] = new_l[:, a - index:b - index]
        return
    rows = index + torch.arange(new_l.shape[1], device=buf_l.device) - lo
    hit = (rows >= 0) & (rows < length)
    at = rows.clamp(0, length - 1).long()
    keep = hit.reshape(1, -1, *([1] * (new_l.dim() - 2)))
    buf_l.index_copy_(1, at, torch.where(keep, new_l,
                                         buf_l.index_select(1, at)))


def _attend(q, k, v, q_offset, kv_len, fn, name: str) -> torch.Tensor:
    """``fn(q, k, v, q_offset, kv_len)`` over (B, S, H, D) operands and
    (B,) row offsets and lengths, through :func:`on_local`: on DTensors on
    each rank's block, as the kernels must and as attention allows (it is
    independent across batch rows and kv-head groups).  q keeps its layout
    (batch and heads may be split, sequence and head dim whole); k and v
    take q's batch split and, where the kv heads divide q's head split,
    its head split, else they are whole and each rank takes the kv heads
    its q heads attend to; a sequence-split cache (the ``kv_seq`` layout)
    is gathered first; the row vectors take q's batch split.  The output
    keeps q's layout."""
    layouts = grads = None
    heads = slice(None)
    if is_dtensor(q):
        q = settled(q)
        mesh = q.device_mesh
        kv, kv_grad, rows = [], [], []
        for i, pq in enumerate(q.placements):
            batch = pq.is_shard() and pq.dim % 4 == 0
            rows.append(Shard(0) if batch else Replicate())
            if batch:
                kv.append(Shard(0))
                kv_grad.append(Shard(0))
            elif (pq.is_shard() and mesh.shape[i] > 1
                  and k.shape[2] % mesh.shape[i]):
                kv.append(Replicate())  # each rank slices its kv heads
                kv_grad.append(Partial())
            else:
                kv.append(pq)
                kv_grad.append(pq)
        head_split = any(pq.is_shard() and pq.dim % 4 == 2 and n > 1
                         for pq, n in zip(q.placements, mesh.shape))
        kv_split = any(p.is_shard() and p.dim == 2 and n > 1
                       for p, n in zip(kv, mesh.shape))
        if head_split and not kv_split:
            start, n = local_range(q, 2)
            group = q.shape[2] // k.shape[2]
            if n % group and group % n:
                raise ValueError(f"{name}: a rank's {n} q heads straddle "
                                 f"kv groups of {group}")
            heads = slice(start // group, (start + n - 1) // group + 1)
        layouts = (None, kv, kv, rows, rows)
        grads = (None, kv_grad, kv_grad, None, None)

    def local(q, k, v, q_offset, kv_len):
        return fn(q, k[:, :, heads], v[:, :, heads], q_offset, kv_len)

    return on_local(local, (q, k, v, q_offset, kv_len),
                    ((1, 3), (1, 3), (1, 3), (), ()), name, layouts=layouts,
                    grads=grads)


class _SameLayoutGrad(torch.autograd.Function):
    """Identity on a DTensor whose gradient takes the forward's layout:
    the merged heads' gradient would come back split where the heads are
    not, and the heads cannot be split out of it again."""

    @staticmethod
    def forward(ctx, x):
        ctx.layout = (x.device_mesh, x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, layout = ctx.layout
        return g if g.placements == layout else g.redistribute(mesh, layout)


def _same_layout_grad(x: torch.Tensor) -> torch.Tensor:
    return _SameLayoutGrad.apply(x) if is_dtensor(x) else x


def split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n * hd) -> (B, S, n, hd).  A DTensor whose last dim is split
    over more ranks than there are heads (or unevenly) is gathered on that
    mesh dim first: DTensor can only split a sharded dim at whole
    heads."""
    if is_dtensor(t):
        mesh = t.device_mesh
        fixed = [Replicate() if (p.is_shard() and p.dim % t.dim() == 2
                                 and n % mesh.shape[i]) else p
                 for i, p in enumerate(t.placements)]
        if fixed != list(t.placements):
            t = t.redistribute(mesh, fixed)
    return t.reshape(t.shape[0], t.shape[1], n, hd)


def attention_layer(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, D)
    *,
    positions: Optional[torch.Tensor] = None,  # (B,S) or (3,B,S) for mrope
    causal: bool = True,
    window: int = 0,
    yarn: Optional[Yarn] = None,  # YaRN rope (cfg.layer_yarn)
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

    q = split_heads(x @ p["wq"], h, hd)
    k = split_heads(src @ p["wk"], n_kv, hd)
    v = split_heads(src @ p["wv"], n_kv, hd)
    q = logical_shard(q, "batch", None, "heads", None)
    k = logical_shard(k, "batch", None, "kv_heads", None)
    v = logical_shard(v, "batch", None, "kv_heads", None)

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
            q = apply_rope(q, positions, cfg.rope_theta, yarn)
            k = apply_rope(k, positions, cfg.rope_theta, yarn)
            q_offset = positions[:, 0]
    else:
        q_offset = torch.zeros((b,), dtype=torch.int32, device=x.device)

    new_cache = None
    kv_len = None
    if cache is not None:
        ck, cv = cache
        _write(ck, k, cache_index)
        _write(cv, v, cache_index)
        ck = logical_shard(ck, "batch", "kv_seq", None, None)
        cv = logical_shard(cv, "batch", "kv_seq", None, None)
        new_cache = (ck, cv)
        kv_len = torch.full((b,), 0, dtype=torch.int32,
                            device=x.device) + (cache_index + s)

    causal = causal and kv_source is None
    if fresh and q.is_cuda:
        if cache is not None:
            k, v = k.to(ck.dtype), v.to(cv.dtype)

        def flash(q, k, v, q_offset, kv_len):
            return ops.flash_attention(
                q.transpose(1, 2).contiguous(),
                k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous(), causal,
                window).transpose(1, 2)
        out = _attend(q, k, v, None, None, flash, "flash_attention")
    else:
        if cache is not None:
            k, v = new_cache

        def chunked(q, k, v, q_offset, kv_len):
            return chunked_attention(
                q, k, v, causal=causal, q_offset=q_offset, window=window,
                kv_len=kv_len, chunk=cfg.attn_chunk)
        out = _attend(q, k, v, q_offset, kv_len, chunked,
                      "chunked_attention")
    out = _same_layout_grad(out.reshape(b, s, h * hd)) @ p["wo"]
    return logical_shard(out, "batch", None, None), new_cache


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


def mlp_specs() -> Dict:
    return {"w_gate": ("w_embed", "w_mlp"), "w_up": ("w_embed", "w_mlp"),
            "w_down": ("w_mlp", "w_embed")}


def mlp(p: Dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    h = logical_shard(h, "batch", None, "mlp_act")
    return logical_shard(h @ p["w_down"], "batch", None, None)
