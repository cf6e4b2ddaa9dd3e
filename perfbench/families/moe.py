"""The moe family on one chip's share of the experts: pre-norm GQA
attention, windowed in some layers and full in the others, with rotary
positions (YaRN on the full layers where the configuration sets it), and
a sparse SwiGLU MLP whose float32 router picks ``top_k`` of all
``n_experts`` for each token, of which this chip holds ``experts_held``
from ``expert_offset`` on; RMSNorm, an untied head.

Weights: the leaves the program keeps, per-layer ones stacked on a
leading axis (``layers.*``); the router is float32 over all the experts,
the experts' leaves hold the held ones.  Layers: plain PyTorch in
float32, written from the published configuration (Mellum2-12B-A2.5B,
hf JetBrains/Mellum2-12B-A2.5B-Instruct ``config.json``; Switch
Transformer's auxiliary loss, arXiv:2101.03961; YaRN, arXiv:2309.00071,
as ``transformers``' ``_compute_yarn_parameters`` computes it).  The
router's softmax over every expert, its top-k renormalised
(``norm_topk_prob``); each held expert computed densely over every token
and weighted by the token's gate for it (0 where the expert is not among
its top-k), so that the experts the chip does not hold add nothing, as
on the chip; the auxiliary term E x sum over experts of the mean
probability times the share of the assignments, from this batch's
tokens, its gradient through the probabilities alone.  Nothing here
imports the program.

``cast`` is applied to both operands of every product that the
configuration runs in bfloat16 (the projections, the experts, Q.K^T and
P.V; not the float32 router): the identity for the reference, a lower
precision for its control.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from .. import workcount
from ..workcount import head_dim
from .dense import Cast, embed, loss, rmsnorm  # noqa: F401 (the contract)

# the program's loss_fn weighs the layers' summed auxiliary terms by this
AUX_WEIGHT = 0.01
EXPERT_LEAVES = ("layers.moe.w_gate", "layers.moe.w_up", "layers.moe.w_down")
# query rows a block of the attention: its scores are (rows, the keys the
# block's queries may see), so that a full layer at 8,192 tokens keeps
# about half of the (S, S) scores for its backward and a windowed one a
# quarter
ATTN_ROWS = 1024


def leaf_specs(model: dict) -> List[tuple]:
    """(name, shape, std[, dtype]) of each weight in the program's tree
    order: the router float32, the rest in ``param_dtype``; the output
    projections' std scaled by the depth, as the program's own
    initialisation does."""
    d, n, vocab = model["d_model"], model["n_layers"], model["vocab"]
    hd, h, kv = head_dim(model), model["n_heads"], model["n_kv"]
    e, held, f = model["n_experts"], model["experts_held"], model["moe_d_ff"]
    out_std = 0.02 / math.sqrt(2 * n)
    return [
        ("embed", (vocab, d), 0.02),
        ("head", (d, vocab), 0.02),
        ("ln_f.scale", (d,), 0.0),
        ("layers.ln_attn.scale", (n, d), 0.0),
        ("layers.attn.wq", (n, d, h * hd), 0.02),
        ("layers.attn.wk", (n, d, kv * hd), 0.02),
        ("layers.attn.wv", (n, d, kv * hd), 0.02),
        ("layers.attn.wo", (n, h * hd, d), out_std),
        ("layers.ln_mlp.scale", (n, d), 0.0),
        ("layers.moe.router", (n, d, e), 0.02, "float32"),
        ("layers.moe.w_gate", (n, held, d, f), 0.02),
        ("layers.moe.w_up", (n, held, d, f), 0.02),
        ("layers.moe.w_down", (n, held, f, d), out_std),
    ]


def token_weights(model: dict) -> int:
    """Every leaf but ``embed``, the held experts at ``top_k`` of all the
    experts."""
    return workcount.token_weights(leaf_specs(model), EXPERT_LEAVES,
                                   model["top_k"], model["n_experts"])


def attention_windows(model: dict) -> List[int]:
    """``window`` on each layer but those where ``i % full_every ==
    full_at``, which see every earlier position."""
    every = model.get("full_every", 0)
    return [0 if every and i % every == model.get("full_at", 0)
            else model.get("window", 0) for i in range(model["n_layers"])]


def _yarn_dim(rotations: float, d: int, theta: float, original: int
              ) -> float:
    return d * math.log(original / (rotations * 2 * math.pi)) \
        / (2 * math.log(theta))


def inv_wavelengths(model: dict, d: int, yarn: bool,
                    device=None) -> Tuple[torch.Tensor, float]:
    """The D/2 inverse wavelengths in float64 and the factor on cos and
    sin: theta^(-2i/D) and 1, or with ``yarn`` those past the ramp from
    ``yarn_beta_fast`` to ``yarn_beta_slow`` rotations over
    ``yarn_original_max`` positions divided by ``yarn_factor``, a linear
    blend inside it, and ``yarn_attention_factor``."""
    theta = model["rope_theta"]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                  device=device) / d)
    if not yarn:
        return inv, 1.0
    original = model["yarn_original_max"]
    low = max(math.floor(_yarn_dim(model["yarn_beta_fast"], d, theta,
                                   original)), 0)
    high = min(math.ceil(_yarn_dim(model["yarn_beta_slow"], d, theta,
                                   original)), d - 1)
    if low == high:
        high += 0.001
    i = torch.arange(d // 2, dtype=torch.float64, device=device)
    ramp = ((i - low) / (high - low)).clamp(0.0, 1.0)
    inv = inv / model["yarn_factor"] * ramp + inv * (1.0 - ramp)
    return inv, model["yarn_attention_factor"]


def rope(x: torch.Tensor, model: dict, yarn: bool) -> torch.Tensor:
    """Rotary embedding of (B, S, H, D) at positions 0..S-1: the pair (i,
    i + D/2) turned by position x the i-th inverse wavelength, angles in
    float64, cos and sin times the factor of :func:`inv_wavelengths`."""
    s, d = x.shape[1], x.shape[-1]
    inv, scale = inv_wavelengths(model, d, yarn, x.device)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = (ang.cos() * scale).to(x.dtype)[None, :, None, :]
    sin = (ang.sin() * scale).to(x.dtype)[None, :, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int, cast: Cast) -> torch.Tensor:
    """Causal GQA attention, (B, S, H, D) x (B, S, Hkv, D)^2 -> (B, S, H,
    D); with ``window`` > 0 a query sees the last ``window`` keys.  By
    blocks of ``ATTN_ROWS`` queries, each over the keys it may see."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    out = []
    for a in range(0, s, ATTN_ROWS):
        e = min(a + ATTN_ROWS, s)
        lo = max(0, a - window + 1) if window > 0 else 0
        i = torch.arange(a, e, device=q.device)[:, None]
        j = torch.arange(lo, e, device=q.device)[None, :]
        allowed = i >= j
        if window > 0:
            allowed &= (i - j) < window
        heads = []
        for n in range(hkv):  # one kv head's group: (B, G, rows, keys)
            qn = q[:, a:e, n * g:(n + 1) * g].transpose(1, 2)
            kn = k[:, lo:e, n].transpose(1, 2)[:, None]
            vn = v[:, lo:e, n][:, None]
            scores = (cast(qn) @ cast(kn) / math.sqrt(d)).masked_fill(
                ~allowed, float("-inf"))
            heads.append(cast(torch.softmax(scores, dim=-1)) @ cast(vn))
        out.append(torch.cat(heads, dim=1).transpose(1, 2))
    return torch.cat(out, dim=1)


def experts(model: dict, hn: torch.Tensor, lp: Dict[str, torch.Tensor],
            cast: Cast) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sparse MLP on the normalised stream hn (B, S, d_model): the
    held experts' part of the output, and the auxiliary term."""
    e, k = model["n_experts"], model["top_k"]
    off, held = model.get("expert_offset", 0), model["experts_held"]
    probs = torch.softmax(hn @ lp["moe.router"], dim=-1)  # float32
    top, idx = torch.topk(probs, k, dim=-1)
    gates = top / top.sum(dim=-1, keepdim=True)
    chosen = torch.nn.functional.one_hot(idx, e).to(probs.dtype)
    share = chosen.detach().sum(dim=(0, 1, 2)) / idx.numel()
    aux = e * torch.sum(probs.mean(dim=(0, 1)) * share)
    weight = (gates[..., None] * chosen).sum(dim=-2)  # (B, S, E)
    y = torch.zeros_like(hn)
    x = cast(hn)
    for j in range(held):
        gate = torch.nn.functional.silu(x @ cast(lp["moe.w_gate"][j]))
        act = gate * (x @ cast(lp["moe.w_up"][j]))
        y = y + weight[..., off + j, None] * (
            cast(act) @ cast(lp["moe.w_down"][j]))
    return y, aux


def block(model: dict, x: torch.Tensor, lp: Dict[str, torch.Tensor],
          cast: Cast, layer: int
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Layer ``layer`` on the float32 residual stream (B, S, d_model);
    ``lp`` holds the layer's float32 weights by their names under
    ``layers.``.  Returns the stream and the layer's auxiliary term."""
    b, s, _ = x.shape
    hd, h, kv = head_dim(model), model["n_heads"], model["n_kv"]
    eps = model["norm_eps"]
    window = attention_windows(model)[layer]
    yarn = window == 0 and bool(model.get("yarn_factor", 0))
    hn = cast(rmsnorm(x, lp["ln_attn.scale"], eps))
    q = (hn @ cast(lp["attn.wq"])).reshape(b, s, h, hd)
    k = (hn @ cast(lp["attn.wk"])).reshape(b, s, kv, hd)
    v = (hn @ cast(lp["attn.wv"])).reshape(b, s, kv, hd)
    o = attention(rope(q, model, yarn), rope(k, model, yarn), v, window,
                  cast)
    x = x + cast(o.reshape(b, s, h * hd)) @ cast(lp["attn.wo"])
    y, aux = experts(model, rmsnorm(x, lp["ln_mlp.scale"], eps), lp, cast)
    return x + y, aux
