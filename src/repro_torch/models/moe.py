"""Mixture-of-Experts with scatter-based capacity dispatch.

Plain PyTorch, the JAX package's ``models/moe.py`` op for op:
  * tokens are grouped PER BATCH ROW, so the position-in-expert cumsum never
    crosses a batch row;
  * dispatch scatter-adds into a (B, E, C, D) buffer instead of the GShard
    one-hot einsum, so the (tokens, E, C) one-hot never materializes;
  * the expert products are batched matmuls over E (``torch.einsum``), the
    scatter and gather ``index_put`` and advanced indexing: the JAX package
    computes them in XLA, outside any Pallas kernel, and so does the port;
  * qwen2-moe style shared experts run as a parallel dense SwiGLU; arctic's
    dense residual branch likewise (``models/model.py``).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import truncated_normal


def init_moe(cfg: ModelConfig, generator: torch.Generator) -> Dict:
    """Router (float32 whatever ``param_dtype`` is) and the stacked expert
    SwiGLU weights."""
    d, f, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
    std = 0.02
    pd = cfg.param_dtype
    return {
        "router": truncated_normal(generator, (d, e), torch.float32, std),
        "w_gate": truncated_normal(generator, (e, d, f), pd, std),
        "w_up": truncated_normal(generator, (e, d, f), pd, std),
        "w_down": truncated_normal(generator, (e, f, d), pd,
                                   std / math.sqrt(2 * cfg.n_layers)),
    }


def _buf_axes(cfg: ModelConfig):
    """Dispatch-buffer logical axes.  The JAX package aligns the buffer's
    expert axis with expert-sharded weights when sharding rules and a mesh
    are active; the port has no sharding rules yet (ROADMAP A15), so this
    is the JAX package's no-mesh case, batch-sharded.  Nothing reads it
    until the port shards."""
    del cfg
    return ("batch", "experts_act", None, None)


def moe_capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    c = int(math.ceil(tokens_per_group * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8, min 8


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last axis and their indices,
    largest first, ties taken lower index first as ``jax.lax.top_k`` takes
    them (``torch.topk`` promises no order among ties): a stable
    descending sort.  Differentiable in the values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p: Dict, cfg: ModelConfig, x: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The float32 router: (probs (B, S, E), normalised gate values and
    expert indices of the top-k, (B, S, k) each)."""
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, cfg.top_k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    return probs, gate_vals, expert_idx


def moe_block(p: Dict, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss). Router in fp32.

    Returns the load-balancing auxiliary loss (Switch-style) alongside the
    output so the training loop can add it."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = moe_capacity(s, cfg)
    probs, gate_vals, expert_idx = _route(p, cfg, x)

    # Switch aux loss: mean(prob per expert) * mean(assignment per expert) * E
    # (its gradient flows through probs.mean only)
    me = probs.mean(dim=(0, 1))  # (E,)
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add_(
        0, expert_idx.reshape(-1),
        torch.full((b * s * k,), 1.0 / (b * s * k), device=x.device))
    aux = torch.sum(me * ce) * e

    # position-in-expert within each batch row (group)
    flat_e = expert_idx.reshape(b, s * k)  # (B, S*k)
    onehot = F.one_hot(flat_e, e)  # (B, S*k, E)
    pos = torch.cumsum(onehot, dim=1) - 1  # (B, S*k, E)
    pos = pos.gather(-1, flat_e[..., None])[..., 0]  # (B, S*k)
    keep = (pos < c).to(x.dtype)  # dropped beyond capacity

    # scatter tokens into the (B, E, C, D) dispatch buffer: a dropped token
    # adds tok * 0 into slot c - 1, which may hold a kept token (exact: the
    # addend is +-0)
    tok = torch.repeat_interleave(x, k, dim=1)  # (B, S*k, D)
    w = keep * gate_vals.reshape(b, s * k).to(x.dtype)
    pos_c = torch.clamp_max(pos, c - 1)
    bidx = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    buf = torch.zeros((b, e, c, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((bidx, flat_e, pos_c), tok * keep[..., None],
                        accumulate=True)

    # expert FFN (SwiGLU)
    h = F.silu(torch.einsum("becd,edf->becf", buf, p["w_gate"]))
    h = h * torch.einsum("becd,edf->becf", buf, p["w_up"])
    out_buf = torch.einsum("becf,efd->becd", h, p["w_down"])

    # gather back and combine with gate weights
    y_slots = out_buf[bidx, flat_e, pos_c]  # (B, S*k, D)
    y = (y_slots * w[..., None]).reshape(b, s, k, d).sum(dim=2)
    return y.to(x.dtype), aux
