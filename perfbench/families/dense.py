"""The dense decoder family: pre-norm GQA attention with rotary positions
and a SwiGLU MLP in each layer, RMSNorm, an untied head.

Weights: the leaves the program keeps, per-layer ones stacked on a
leading axis (``layers.*``).  Layers: plain PyTorch in float32, written
from the published description (InternLM2, arXiv:2403.17297; Mistral,
arXiv:2310.06825; Llama, arXiv:2302.13971): RMSNorm over the last axis,
rotary embedding on the two halves of each head, causal attention with
an optional sliding window of ``window`` keys (a query sees the key at
its own position and the ``window - 1`` before it), SiLU(x W_gate) *
(x W_up) W_down, and a cross entropy over the head's logits.  Nothing
here imports the program.

``cast`` is applied to both operands of every product that the
configuration runs in bfloat16 (the projections, the MLP, Q.K^T and
P.V): the identity for the reference, a lower precision for its control.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .. import workcount
from ..workcount import head_dim

Cast = Callable[[torch.Tensor], torch.Tensor]
# the program's loss has no auxiliary term for this family
AUX_WEIGHT = 0.0


def leaf_specs(model: dict) -> List[tuple]:
    """(name, shape, std) of each weight in the program's tree order, all
    in ``param_dtype``; the output projections' std is scaled by the
    depth, as the program's own initialisation does."""
    d, n, vocab = model["d_model"], model["n_layers"], model["vocab"]
    hd, h, kv, f = (head_dim(model), model["n_heads"], model["n_kv"],
                    model["d_ff"])
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
        ("layers.mlp.w_gate", (n, d, f), 0.02),
        ("layers.mlp.w_up", (n, d, f), 0.02),
        ("layers.mlp.w_down", (n, f, d), out_std),
    ]


def token_weights(model: dict) -> int:
    return workcount.token_weights(leaf_specs(model))


def attention_windows(model: dict) -> List[int]:
    return [model.get("window", 0)] * model["n_layers"]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of (B, S, H, D) at positions 0..S-1: the pair (i,
    i + D/2) turned by position / theta^(2i/D), angles in float64."""
    s, d = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                  device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = ang.cos().to(x.dtype)[None, :, None, :]
    sin = ang.sin().to(x.dtype)[None, :, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int, cast: Cast) -> torch.Tensor:
    """Causal GQA attention, (B, S, H, D) x (B, S, Hkv, D)^2 -> (B, S, H,
    D); with ``window`` > 0 a query sees the last ``window`` keys."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    i = torch.arange(s, device=q.device)
    allowed = i[:, None] >= i[None, :]
    if window > 0:
        allowed &= (i[:, None] - i[None, :]) < window
    outs = []
    for j in range(hkv):  # one kv head's group at a time: (B, G, S, S)
        qj = q[:, :, j * g:(j + 1) * g].transpose(1, 2)
        kj = k[:, :, j].transpose(1, 2)[:, None]    # (B, 1, D, S)
        vj = v[:, :, j][:, None]                    # (B, 1, S, D)
        scores = (cast(qj) @ cast(kj) / math.sqrt(d)).masked_fill(
            ~allowed, float("-inf"))
        outs.append(cast(torch.softmax(scores, dim=-1)) @ cast(vj))
    return torch.cat(outs, dim=1).transpose(1, 2)


def embed(top: Dict[str, torch.Tensor], tokens: torch.Tensor
          ) -> torch.Tensor:
    return top["embed"][tokens].float()


def block(model: dict, x: torch.Tensor, lp: Dict[str, torch.Tensor],
          cast: Cast, layer: int
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Layer ``layer`` on the float32 residual stream (B, S, d_model);
    ``lp`` holds the layer's float32 weights by their names under
    ``layers.``.  No auxiliary term."""
    b, s, _ = x.shape
    hd, h, kv = head_dim(model), model["n_heads"], model["n_kv"]
    eps = model["norm_eps"]
    hn = cast(rmsnorm(x, lp["ln_attn.scale"], eps))
    q = (hn @ cast(lp["attn.wq"])).reshape(b, s, h, hd)
    k = (hn @ cast(lp["attn.wk"])).reshape(b, s, kv, hd)
    v = (hn @ cast(lp["attn.wv"])).reshape(b, s, kv, hd)
    theta = model["rope_theta"]
    o = attention(rope(q, theta), rope(k, theta), v,
                  attention_windows(model)[layer], cast)
    x = x + cast(o.reshape(b, s, h * hd)) @ cast(lp["attn.wo"])
    hn = cast(rmsnorm(x, lp["ln_mlp.scale"], eps))
    gate = torch.nn.functional.silu(hn @ cast(lp["mlp.w_gate"]))
    act = gate * (hn @ cast(lp["mlp.w_up"]))
    return x + cast(act) @ cast(lp["mlp.w_down"]), None


def loss(model: dict, x: torch.Tensor, top: Dict[str, torch.Tensor],
         labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy of the float32 head over the final
    norm (the head is float32 in the configuration: no cast)."""
    hn = rmsnorm(x, top["ln_f.scale"], model["norm_eps"])
    logits = hn @ top["head"]
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()
