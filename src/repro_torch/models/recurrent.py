"""Recurrent temporal mixing: the RG-LRU block of Griffin / RecurrentGemma.

Plain PyTorch, the JAX package's ``models/recurrent.py`` (its RG-LRU half)
op for op, with two execution modes:
  * sequence mode (prefill): the recurrence over the whole prompt goes
    through ``kernels.ops.rg_lru`` — the RG-LRU kernel on a CUDA device,
    its plain version on the CPU — where the JAX package runs an
    associative scan;
  * step mode (decode): an O(1) elementwise state update.

The xLSTM cells (sLSTM, mLSTM) are not ported yet (ROADMAP A13b).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig
from .layers import truncated_normal


def init_rg_lru(cfg: ModelConfig, generator: torch.Generator) -> Dict:
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    std = 0.02
    pd = cfg.param_dtype
    return {
        # input / gate projections (the Griffin recurrent block)
        "w_x": truncated_normal(generator, (d, w), pd, std),
        "w_gate": truncated_normal(generator, (d, w), pd, std),
        "w_out": truncated_normal(generator, (w, d), pd,
                                  std / math.sqrt(2 * cfg.n_layers)),
        # rg-lru gates
        "w_a": truncated_normal(generator, (w, w), pd, std),
        "w_i": truncated_normal(generator, (w, w), pd, std),
        # Lambda parametrized so a = sigmoid(lam)^(8*sigmoid(r)) starts ~0.95
        "lam": torch.full((w,), 3.0, dtype=torch.float32,
                          device=generator.device),
        # short conv (Griffin conv1d width 4)
        "conv": truncated_normal(generator, (cfg.conv_width, w), pd, std),
    }


def _rg_gates(p: Dict, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a_t (decay) and gated input multiplier, both fp32. u: (..., W)."""
    r = torch.sigmoid((u @ p["w_a"]).float())
    i = torch.sigmoid((u @ p["w_i"]).float())
    log_a = 8.0 * r * F.logsigmoid(p["lam"].float())
    return torch.exp(log_a), i


def rg_lru_scan(p: Dict, u: torch.Tensor, h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u: (B, S, W) gated input. Returns (y (B,S,W), h_final (B,W) fp32).

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t), from h0 (zero when
    None), through ``ops.rg_lru`` on float32 (B, S, W) tensors."""
    a, i = _rg_gates(p, u)
    x = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-6)) * (i * u.float())
    if h0 is not None:
        # fold the carried state into the first step
        x[:, 0] += a[:, 0] * h0.float()
    y = ops.rg_lru(a, x)
    # clone: a view would keep the whole (B, S, W) output alive in the cache
    return y.to(u.dtype), y[:, -1].clone()


def rg_lru_step(p: Dict, u: torch.Tensor, h: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. u: (B, 1, W), h: (B, W)."""
    a, i = _rg_gates(p, u[:, 0])
    x = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-6)) * (i * u[:, 0].float())
    h_new = a * h.float() + x
    return h_new.to(u.dtype)[:, None], h_new.to(u.dtype)


def causal_conv1d(p_conv: torch.Tensor, x: torch.Tensor,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B,S,W); state: (B, width-1, W)."""
    width = p_conv.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                            dtype=x.dtype, device=x.device)
    xt = torch.cat([state, x], dim=1)
    out = sum(xt[:, i:i + x.shape[1]] * p_conv[i] for i in range(width))
    new_state = xt[:, -(width - 1):].clone() if width > 1 else state
    return out.to(x.dtype), new_state


def griffin_recurrent_block(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                            state: Optional[Dict] = None
                            ) -> Tuple[torch.Tensor, Dict]:
    """The Griffin recurrent temporal block: (conv -> RG-LRU) x gelu gate."""
    u = x @ p["w_x"]
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    if state is None or u.shape[1] > 1:  # sequence mode (prefill)
        conv_in = None if state is None else state["conv"]
        u, conv_state = causal_conv1d(p["conv"], u, conv_in)
        y, h = rg_lru_scan(p, u, None if state is None else state["h"])
        new_state = {"conv": conv_state, "h": h.to(u.dtype)}
    else:
        u, conv_state = causal_conv1d(p["conv"], u, state["conv"])
        y, h = rg_lru_step(p, u, state["h"])
        new_state = {"conv": conv_state, "h": h}
    return (y * gate) @ p["w_out"], new_state


def init_griffin_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                       device: Optional[torch.device] = None) -> Dict:
    w = cfg.lru_width or cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, w), dtype=dtype, device=device),
    }
