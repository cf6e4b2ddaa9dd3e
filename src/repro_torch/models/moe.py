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
from torch.distributed.tensor import DTensor, Partial, Replicate

from ..sharding import current_rules, logical_shard
from ..sharding.local import on_local, settled
from .config import ModelConfig
from .layers import truncated_normal
from .remat import unbatched_product


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


def moe_specs() -> Dict:
    # the router is tiny (d_model x E): replicated, as in the JAX package
    return {"router": (None, None), "w_gate": ("w_experts", None, "w_mlp"),
            "w_up": ("w_experts", None, "w_mlp"),
            "w_down": ("w_experts", "w_mlp", None)}


def _buf_axes(cfg: ModelConfig):
    """Dispatch-buffer sharding. EP mode aligns the buffer's expert axis
    with the expert-sharded weights (token all-to-all, expert grads stay
    local -- no cross-data grad all-reduce for expert weights); fallback is
    batch sharding when the expert count doesn't divide the data axis."""
    rules = current_rules()
    if cfg.moe_ep_dispatch and rules is not None and rules.mesh is not None:
        dp = rules.shape.get("data", 1)
        if cfg.n_experts % max(dp, 1) == 0:
            return (None, "w_experts", None, None)
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
    with unbatched_product():  # a product without batch dims (remat "dots")
        logits = torch.einsum("bsd,de->bse", x.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, cfg.top_k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    return probs, gate_vals, expert_idx


def _dispatch(router: torch.Tensor, cfg: ModelConfig, x: torch.Tensor,
              c: int, n_assign: int):
    """Routing and dispatch of whole batch rows: (probs (B, S, E), the
    assignment share per expert (E,), the (B, E, C, D) dispatch buffer,
    and each assignment's expert, slot and gate weight (B, S*k)).  Each
    assignment adds ``1 / n_assign`` to its expert's share."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    probs, gate_vals, expert_idx = _route({"router": router}, cfg, x)
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add_(
        0, expert_idx.reshape(-1),
        torch.full((b * s * k,), 1.0 / n_assign, device=x.device))

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
    return probs, ce, buf, flat_e, pos_c, w


def _combine(out_buf: torch.Tensor, flat_e: torch.Tensor,
             pos_c: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """Gather each assignment's expert output back to its token and sum
    the top-k with their gate weights: (B, S, D)."""
    b, sk = flat_e.shape
    bidx = torch.arange(b, device=out_buf.device)[:, None].expand(b, sk)
    y_slots = out_buf[bidx, flat_e, pos_c]  # (B, S*k, D)
    return (y_slots * w[..., None]).reshape(b, sk // k, k, -1).sum(dim=2)


def moe_block(p: Dict, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss). Router in fp32.

    Returns the load-balancing auxiliary loss (Switch-style) alongside the
    output so the training loop can add it.

    On DTensors, routing, dispatch and combine run on each rank's batch
    rows (``on_local``; DTensor has no sharding rule for the stable sort,
    the cumsum's gather or the accumulating ``index_put``): the rows must
    be whole on each rank, the expert share is a partial sum over them, and
    the buffer and expert products take the JAX package's layouts
    (``_buf_axes``) through DTensor."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = moe_capacity(s, cfg)
    rows = dispatch = None
    if isinstance(x, DTensor):
        x = settled(x)
        rows = tuple(x.placements)
        part = tuple(Partial() if pl.is_shard() else Replicate()
                     for pl in rows)
        # the router is replicated: its gradient a partial sum over rows
        dispatch = dict(layouts=(None, [Replicate()] * x.device_mesh.ndim),
                        grads=(None, part),
                        out=[rows, part, rows, rows, rows, rows])
    probs, ce, buf, flat_e, pos_c, w = on_local(
        lambda x, router: _dispatch(router, cfg, x, c, b * s * k),
        (x, p["router"]), ((1, 2), ()), "moe_block", **(dispatch or {}))

    # Switch aux loss: mean(prob per expert) * mean(assignment per expert) * E
    # (its gradient flows through probs.mean only)
    me = probs.mean(dim=(0, 1))  # (E,)
    aux = torch.sum(me * ce) * e

    buf = logical_shard(buf, *_buf_axes(cfg))

    # expert FFN (SwiGLU)
    h = F.silu(torch.einsum("becd,edf->becf", buf, p["w_gate"]))
    h = h * torch.einsum("becd,edf->becf", buf, p["w_up"])
    out_buf = torch.einsum("becf,efd->becd", h, p["w_down"])
    out_buf = logical_shard(out_buf, *_buf_axes(cfg))

    # gather back and combine with gate weights, on whole batch rows (the
    # combine's all-to-all / all-gather)
    y = on_local(lambda out_buf, flat_e, pos_c, w: _combine(
        out_buf, flat_e, pos_c, w, k), (out_buf, flat_e, pos_c, w),
        ((1, 2, 3), (), (), ()), "moe_combine",
        layouts=(rows, None, None, None))
    y = logical_shard(y, "batch", None, None)
    return y.to(x.dtype), aux
