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

:func:`held_experts_block` is the port's own dropless layer of a chip
that holds a share of the experts (expert parallelism without its
exchange): it routes over every expert, computes each assignment that
lands on a held expert as one grouped product over the held experts, and
drops nothing.  While a profiler records it marks its work with spans:
``repro_torch.moe.route`` (the router product, softmax, top-k, the aux
loss, the selection, the sort and the gather of the rows),
``repro_torch.moe.experts`` (the grouped products and the SwiGLU: the
forward, remat's recompute, and the backward on autograd's device
thread) and ``repro_torch.moe.combine`` (the gate weights and the sum
back into the tokens).  The backward of the gathers and of the sum runs
outside them, in the step's backward.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

from .._spans import span
from ..sharding import current_rules, logical_shard
from ..sharding.local import on_local, settled
from .config import ModelConfig
from .layers import truncated_normal
from .remat import unbatched_product


ROUTE_SPAN = "repro_torch.moe.route"
EXPERTS_SPAN = "repro_torch.moe.experts"
COMBINE_SPAN = "repro_torch.moe.combine"
# :func:`held_experts_block`'s counters and how they join: the rows
# summed, the load's worst taken
COUNTERS = {"moe_held_rows": torch.add, "moe_held_load_max": torch.maximum}
# the rows of each held expert's group are padded to a multiple of this,
# and to at least this, for the grouped product (zero rows, dropped on
# the combine)
GROUP_ROWS = 16


def init_moe(cfg: ModelConfig, generator: torch.Generator) -> Dict:
    """Router (float32 whatever ``param_dtype`` is, over all
    ``n_experts``) and the stacked expert SwiGLU weights of the experts
    held here (``cfg.n_held``)."""
    d, f, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_held
    std = 0.02
    pd = cfg.param_dtype
    return {
        "router": truncated_normal(generator, (d, cfg.n_experts),
                                   torch.float32, std),
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


# ---------------------------------------------------------------------------
# the dropless layer over the experts held here
# ---------------------------------------------------------------------------

def _grouped(a: torch.Tensor, b: torch.Tensor,
             offs: torch.Tensor) -> torch.Tensor:
    """Per group ``g`` of rows ``[offs[g-1], offs[g])``: ``a``'s rows times
    ``b[g]`` where ``b`` is 3-d (``(N, K) x (G, K, M) -> (N, M)``), or
    ``a``'s columns times ``b``'s rows where both are 2-d (``(K, N) x (N,
    M) -> (G, K, M)``); rows past ``offs[-1]`` take part in no group.  One
    ``torch._grouped_mm`` for bfloat16 CUDA operands, which leaves the
    result's rows past ``offs[-1]`` unwritten; one ``mm`` a group
    elsewhere, zeros past ``offs[-1]`` (the offsets read back to the host:
    the plain path)."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch._grouped_mm(a, b, offs=offs)
    ends = offs.tolist()
    starts = [0] + ends[:-1]
    if b.dim() == 3:
        parts = [a[lo:hi] @ b[g] for g, (lo, hi)
                 in enumerate(zip(starts, ends))]
        return torch.cat(parts + [a.new_zeros((a.shape[0] - ends[-1],
                                               b.shape[-1]))])
    return torch.stack([a[:, lo:hi] @ b[lo:hi]
                        for lo, hi in zip(starts, ends)])


class _HeldExperts(torch.autograd.Function):
    """The SwiGLU of the held experts over rows sorted and padded by
    expert: ``(silu(x W_gate[g]) * (x W_up[g])) W_down[g]`` for group g's
    rows, by grouped products; the rows past ``offs[-1]`` are no group's:
    their output and their gradient are zero (the grouped product leaves
    them unwritten on the card, and what it left is masked out before it
    can reach a group's rows).  The backward computes dX and the three dW
    by grouped products too, inside the experts' span opened on the
    thread that runs it (autograd's device thread on the card)."""

    @staticmethod
    def forward(ctx, x, offs, w_gate, w_up, w_down):
        with span(EXPERTS_SPAN):
            live = _live(x, offs)
            g = _grouped(x, w_gate, offs)
            u = _grouped(x, w_up, offs)
            out = _grouped(F.silu(g) * u, w_down, offs)
            out = torch.where(live, out, 0)
        ctx.save_for_backward(x, offs, w_gate, w_up, w_down, g, u)
        return out

    @staticmethod
    def backward(ctx, d_out):
        x, offs, w_gate, w_up, w_down, g, u = ctx.saved_tensors
        with span(EXPERTS_SPAN):
            live = _live(x, offs)
            d_out = d_out.contiguous()
            dh = torch.where(live, _grouped(d_out, w_down.transpose(1, 2),
                                            offs).float(), 0)
            g32 = torch.where(live, g.float(), 0)
            u32 = torch.where(live, u.float(), 0)
            sig = torch.sigmoid(g32)
            act = g32 * sig  # silu(g)
            d_down = _grouped((act * u32).to(x.dtype).t(), d_out, offs)
            du = (dh * act).to(x.dtype)
            dg = (dh * u32 * (sig * (1 + g32 * (1 - sig)))).to(x.dtype)
            del dh, g32, u32, sig, act
            d_gate = _grouped(x.t(), dg, offs)
            d_up = _grouped(x.t(), du, offs)
            dx = (_grouped(dg, w_gate.transpose(1, 2), offs)
                  + _grouped(du, w_up.transpose(1, 2), offs))
            dx = torch.where(live, dx, 0)
        return dx, None, d_gate, d_up, d_down


def _live(x: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """(rows, 1): True for the rows of ``x`` inside a group."""
    return (torch.arange(x.shape[0], device=x.device) < offs[-1])[:, None]


def _route_held(router: torch.Tensor, cfg: ModelConfig, x: torch.Tensor):
    """The router over all ``n_experts`` on whole batch rows: (probs (B,
    S, E), the gate values and experts of the top-k (B, S, k), and each
    expert's count of assignments (E,) in float32)."""
    b, s, _ = x.shape
    probs, gate_vals, expert_idx = _route({"router": router}, cfg, x)
    counts = torch.zeros((cfg.n_experts,), dtype=torch.float32,
                         device=x.device).index_add_(
        0, expert_idx.reshape(-1),
        torch.ones((b * s * cfg.top_k,), dtype=torch.float32,
                   device=x.device))
    return probs, gate_vals, expert_idx, counts


def _held_layer(cfg: ModelConfig, x, gate_vals, expert_idx, w_gate, w_up,
                w_down) -> torch.Tensor:
    """The held experts' part of the layer for every token, (B, S, D) in
    x's dtype: the assignments to experts ``[expert_offset, expert_offset
    + n_held)`` sorted by expert (stably), their rows gathered into groups
    padded to ``GROUP_ROWS``, the grouped SwiGLU, and each token's results
    times their gate values summed over its top-k.

    Nothing is read back to the host, so no size depends on the routing:
    the buffer has a row for every assignment and the groups' padding;
    the held assignments fill the groups, the others the rows past the
    last group, which no group computes and whose output is zero.  Every
    assignment has a row of its own, so neither gather adds into a row
    twice."""
    b, s, d = x.shape
    t, k, n_held = b * s, cfg.top_k, cfg.n_held
    n = t * k
    with span(ROUTE_SPAN):
        local = expert_idx.reshape(-1) - cfg.expert_offset
        held = (local >= 0) & (local < n_held)
        group, order = torch.sort(torch.where(held, local, n_held),
                                  stable=True)
        counts = torch.bincount(group, minlength=n_held + 1)[:n_held]
        padded = (counts + GROUP_ROWS - 1).div(
            GROUP_ROWS, rounding_mode="floor").clamp_min(1) * GROUP_ROWS
        ends = padded.cumsum(0)
        # each sorted assignment's row: a held one's index among the held
        # moved by the padding of the groups before it, the others after
        # the last group
        shift = torch.cat([(ends - padded) - (counts.cumsum(0) - counts),
                           (ends[-1] - counts.sum())[None]])
        row = torch.arange(n, device=x.device) + shift[group]
        pos = torch.empty_like(row).scatter_(0, order, row)  # token-major
        rows = x.new_zeros((n + n_held * GROUP_ROWS, d))
        rows.index_put_((pos,), x.reshape(t, 1, d).expand(t, k, d)
                        .reshape(n, d))
    out = _HeldExperts.apply(rows, ends.to(torch.int32), w_gate, w_up,
                             w_down)
    with span(COMBINE_SPAN):
        # the unheld assignments' rows lie past the last group: zeros
        y = (out[pos].reshape(t, k, d)
             * gate_vals.reshape(t, k, 1).to(x.dtype)).sum(dim=1)
    return y.reshape(b, s, d)


def held_experts_block(p: Dict, cfg: ModelConfig, x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (y, aux_loss, counters): the dropless layer of a
    chip that holds experts ``[expert_offset, expert_offset + n_held)``
    of the router's ``n_experts``.  Router in fp32 over all the experts;
    the Switch aux loss over all of them from these tokens, as
    :func:`moe_block` computes it; the absent experts' part of the result
    left out (it is another chip's).  Counters, float32 device tensors:
    ``moe_held_rows``, the assignments computed here (padding excluded),
    and ``moe_held_load_max``, the largest held expert's rows over the
    held experts' mean.

    On DTensors routing runs on each rank's batch rows (``on_local``), the
    counts a partial sum over them; the experts and the combine run on
    each rank's rows with the expert weights whole, their gradients
    partial sums over the rows' split."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    route = experts = None
    if isinstance(x, DTensor):
        x = settled(x)
        rows = tuple(x.placements)
        part = tuple(Partial() if pl.is_shard() else Replicate()
                     for pl in rows)
        whole = [Replicate()] * x.device_mesh.ndim
        route = dict(layouts=(None, whole), grads=(None, part),
                     out=[rows, rows, rows, part])
        experts = dict(layouts=(None, rows, rows, whole, whole, whole),
                       grads=(None, None, None, part, part, part),
                       out=rows)
    with span(ROUTE_SPAN):
        probs, gate_vals, expert_idx, counts = on_local(
            lambda x, router: _route_held(router, cfg, x),
            (x, p["router"]), ((1, 2), ()), "moe_route", **(route or {}))
        # Switch aux loss: mean(prob per expert) * mean(assignment per
        # expert) * E (its gradient flows through probs.mean only)
        aux = torch.sum(probs.mean(dim=(0, 1)) * counts) * e / (b * s * k)
    y = on_local(
        lambda x, gv, ei, wg, wu, wd: _held_layer(cfg, x, gv, ei, wg, wu,
                                                  wd),
        (x, gate_vals, expert_idx, p["w_gate"], p["w_up"], p["w_down"]),
        ((1, 2), (), (), (0, 1, 2), (0, 1, 2), (0, 1, 2)), "moe_experts",
        **(experts or {}))
    held = counts[cfg.expert_offset:cfg.expert_offset + cfg.n_held]
    counters = {"moe_held_rows": held.sum(),
                "moe_held_load_max": held.amax()
                / held.mean().clamp_min(1e-9)}
    return logical_shard(y, "batch", None, None), aux, counters
