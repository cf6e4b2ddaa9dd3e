"""Recurrent temporal mixing: the RG-LRU block of Griffin / RecurrentGemma,
and the xLSTM cells (sLSTM, mLSTM).

Plain PyTorch, the JAX package's ``models/recurrent.py`` op for op, with
two execution modes:
  * sequence mode (prefill): the RG-LRU recurrence over the whole prompt
    goes through ``kernels.ops.rg_lru`` — the RG-LRU kernel on a CUDA
    device, its plain version on the CPU — where the JAX package runs an
    associative scan; the sLSTM runs the JAX package's associative scan
    (``_assoc_scan``), the mLSTM its chunkwise-parallel form;
  * step mode (decode): an O(1) state update.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Shard

from ..kernels import ops
from ..sharding import logical_shard
from ..sharding.local import is_dtensor, on_local, settled
from ._assoc_scan import associative_scan
from .config import ModelConfig
from .layers import split_heads, truncated_normal


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


def _logsigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid``, elementwise on each rank's block for a DTensor
    (DTensor has no sharding rule for its backward)."""
    return on_local(F.logsigmoid, (x,), ((),), "logsigmoid")


def rg_lru_specs() -> Dict:
    return {"w_x": ("w_embed", "w_state"), "w_gate": ("w_embed", "w_state"),
            "w_out": ("w_state", "w_embed"), "w_a": ("w_state", None),
            "w_i": ("w_state", None), "lam": (None,),
            "conv": (None, "w_state")}


def _rg_gates(p: Dict, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a_t (decay) and gated input multiplier, both fp32. u: (..., W)."""
    r = torch.sigmoid((u @ p["w_a"]).float())
    i = torch.sigmoid((u @ p["w_i"]).float())
    log_a = 8.0 * r * _logsigmoid(p["lam"].float())
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
    # on DTensors the kernel runs on each rank's block: the time axis must
    # be whole there
    a = logical_shard(a, "batch", None, "w_state")
    x = logical_shard(x, "batch", None, "w_state")
    y = on_local(ops.rg_lru, (a, x), ((1,), (1,)), "rg_lru")
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
    u = logical_shard(x @ p["w_x"], "batch", None, "w_state")
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
    return logical_shard((y * gate) @ p["w_out"], "batch", None, None), \
        new_state


def init_griffin_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                       device: Optional[torch.device] = None) -> Dict:
    w = cfg.lru_width or cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, w), dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# xLSTM: sLSTM block (scalar memory) and mLSTM block (matrix memory)
# ---------------------------------------------------------------------------

def init_slstm(cfg: ModelConfig, generator: torch.Generator) -> Dict:
    d = cfg.d_model
    std = 0.02
    pd = cfg.param_dtype
    return {
        "w_z": truncated_normal(generator, (d, d), pd, std),
        "w_i": truncated_normal(generator, (d, d), pd, std),
        "w_f": truncated_normal(generator, (d, d), pd, std),
        "w_o": truncated_normal(generator, (d, d), pd, std),
        "w_out": truncated_normal(generator, (d, d), pd,
                                  std / math.sqrt(2 * cfg.n_layers)),
    }


def slstm_specs() -> Dict:
    return {k: ("w_embed", "w_state")
            for k in ("w_z", "w_i", "w_f", "w_o", "w_out")}


def _slstm_combine(c1, c2):
    f1, m1, cc1, nn1 = c1
    f2, m2, cc2, nn2 = c2
    m = torch.maximum(m1 + f2, m2)
    scale1 = torch.exp(m1 + f2 - m)
    scale2 = torch.exp(m2 - m)
    return f1 + f2, m, cc1 * scale1 + cc2 * scale2, nn1 * scale1 + nn2 * scale2


def slstm_scan(p: Dict, x: torch.Tensor, state: Optional[Dict] = None
               ) -> Tuple[torch.Tensor, Dict]:
    """sLSTM with exponential gating (input-conditioned gates). x: (B, S, D).

    c_t = f_t c_{t-1} + i_t z_t ;  n_t = f_t n_{t-1} + i_t ;  h = o * c/n
    with log-space stabilizer m_t = max(log f_t + m_{t-1}, log i_t), as an
    associative scan over (cumulative log f, running max m, stabilized c,
    stabilized n); a carried ``state`` (c, n, m) is folded into step 0."""
    z = torch.tanh((x @ p["w_z"]).float())
    log_i = (x @ p["w_i"]).float()
    log_f = _logsigmoid((x @ p["w_f"]).float())
    o = torch.sigmoid((x @ p["w_o"]).float())

    m0 = log_i  # per-step stabilizer
    c_elems = [log_f, m0, torch.exp(log_i - m0) * z, torch.exp(log_i - m0)]
    if state is not None:
        f0, mm0, cc0, nn0 = (log_f[:, 0], m0[:, 0], c_elems[2][:, 0],
                             c_elems[3][:, 0])
        m_in = state["m"].float()
        mm = torch.maximum(m_in + f0, mm0)
        cc = (state["c"].float() * torch.exp(m_in + f0 - mm)
              + cc0 * torch.exp(mm0 - mm))
        nn = (state["n"].float() * torch.exp(m_in + f0 - mm)
              + nn0 * torch.exp(mm0 - mm))
        c_elems = [c_elems[0]] + [
            torch.cat([v[:, None], e[:, 1:]], dim=1)
            for v, e in zip((mm, cc, nn), c_elems[1:])]
    # the scan is along time and elementwise across batch rows and state
    # columns: on DTensors each rank scans its block (time whole)
    _, m, c, n = on_local(
        lambda *e: tuple(associative_scan(_slstm_combine, list(e), axis=1)),
        [logical_shard(e, "batch", None, "w_state") for e in c_elems],
        ((1,),) * 4, "slstm_scan")
    h = o * (c / torch.clamp_min(n.abs(), 1.0))
    y = logical_shard(h.to(x.dtype) @ p["w_out"], "batch", None, None)
    new_state = {"c": c[:, -1], "n": n[:, -1], "m": m[:, -1]}
    return y, new_state


def init_slstm_state(cfg: ModelConfig, batch: int,
                     device: Optional[torch.device] = None) -> Dict:
    d = cfg.d_model
    z = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return {"c": z, "n": z.clone(),
            "m": torch.full((batch, d), -1e30, dtype=torch.float32,
                            device=device)}


def init_mlstm(cfg: ModelConfig, generator: torch.Generator) -> Dict:
    d, h = cfg.d_model, cfg.n_heads
    std = 0.02
    pd = cfg.param_dtype
    return {
        "w_q": truncated_normal(generator, (d, d), pd, std),
        "w_k": truncated_normal(generator, (d, d), pd, std),
        "w_v": truncated_normal(generator, (d, d), pd, std),
        "w_i": truncated_normal(generator, (d, h), pd, std),
        "w_f": truncated_normal(generator, (d, h), pd, std),
        "w_out": truncated_normal(generator, (d, d), pd,
                                  std / math.sqrt(2 * cfg.n_layers)),
    }


def mlstm_specs() -> Dict:
    return {"w_q": ("w_embed", "w_heads"), "w_k": ("w_embed", "w_heads"),
            "w_v": ("w_embed", "w_heads"), "w_i": ("w_embed", None),
            "w_f": ("w_embed", None), "w_out": ("w_heads", "w_embed")}


def _mlstm_chunks(q, k, v, log_i, log_f, C, n, chunk: int):
    """The chunkwise mLSTM over (B, S, H, hd) q, k, v and (B, S, H) gates
    from carried (C, n) (zero when None): (h (B, S, H, hd), C, n)."""
    b, s, nh, hd = q.shape
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=q.device).tril()
    if C is None:
        C = torch.zeros((b, nh, hd, hd), dtype=torch.float32, device=q.device)
        n = torch.zeros((b, nh, hd), dtype=torch.float32, device=q.device)
    hs = []
    for c0 in range(0, s, chunk):
        qb, kb, vb, ib, fb = (t[:, c0:c0 + chunk]
                              for t in (q, k, v, log_i, log_f))
        f_cum = torch.cumsum(fb, dim=1)  # (B,chunk,H)
        f_tot = f_cum[:, -1]
        # intra-chunk decay matrix D[t, t'] = exp(f_cum_t - f_cum_t' + i_t')
        logD = (f_cum[:, :, None, :] - f_cum[:, None, :, :]
                + ib[:, None, :, :])  # (B,t,t',H)
        logD = torch.where(mask[None, :, :, None], logD, -math.inf)
        # stabilizer per query step
        m_intra = logD.amax(dim=2)  # (B,t,H)
        m_inter = f_cum  # decay applied to carried state
        m = torch.maximum(m_intra, m_inter)
        Dm = torch.exp(logD - m[:, :, None, :])
        s_qk = torch.einsum("bthd,bshd->btsh", qb, kb) * Dm
        intra = torch.einsum("btsh,bshd->bthd", s_qk, vb)
        inter_scale = torch.exp(m_inter - m)  # (B,t,H)
        inter = torch.einsum("bthd,bhde->bthe", qb, C) * inter_scale[..., None]
        num = intra + inter
        den_intra = s_qk.sum(dim=2)  # (B,t,H)
        den_inter = torch.einsum("bthd,bhd->bth", qb, n) * inter_scale
        den = torch.maximum((den_intra + den_inter).abs(), torch.exp(-m))
        hs.append(num / den[..., None])
        # C' = exp(f_tot) C + sum_t exp(f_tot - f_cum_t + i_t) k_t v_t^T
        w_t = torch.exp(f_tot[:, None, :] - f_cum + ib)  # (B,chunk,H)
        C = torch.exp(f_tot)[:, :, None, None] * C + torch.einsum(
            "bthd,bthe->bhde", kb * w_t[..., None], vb)
        n = torch.exp(f_tot)[:, :, None] * n + torch.einsum(
            "bthd,bth->bhd", kb, w_t)
    return torch.cat(hs, dim=1), C, n


def _mlstm_local(q, k, v, log_i, log_f, C, n, chunk: int):
    """:func:`_mlstm_chunks` through :func:`on_local`: on DTensors on each
    rank's block of batch rows and heads (the recurrence runs along time
    within a head), the gates (B, S, H) split as q's first three dims are,
    the carried state split as the heads are."""
    layouts = out = None
    if is_dtensor(q):
        layout = settled(q).placements
        # (B, S, H, hd) -> state (B, H, ...): heads move from dim 2 to dim 1
        state = [Shard(1) if p.is_shard() and p.dim == 2 else p
                 for p in layout]
        layouts = (None, layout, layout, layout, layout, state, state)
        out = [layout, state, state]
    return on_local(lambda *a: _mlstm_chunks(*a, chunk),
                    (q, k, v, log_i, log_f, C, n),
                    ((1, 3), (1, 3), (1, 3), (1,), (1,), (), ()), "mlstm",
                    layouts=layouts, out=out)


def mlstm_chunkwise(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                    chunk: int = 256, state: Optional[Dict] = None,
                    return_state: bool = False):
    """Chunkwise-parallel mLSTM (matrix memory): intra-chunk quadratic with
    decay mask + inter-chunk carried (C, n) state. x: (B, S, D); S must be
    a multiple of ``chunk`` when it is longer.

    NOTE on prefill->decode handoff: the chunkwise form carries an
    unstabilized (C, n); the returned state therefore has m = 0 (identity
    scale), which the step form consumes directly."""
    b, s, d = x.shape
    nh = cfg.n_heads
    hd = d // nh
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"mLSTM: sequence length {s} is not a multiple of "
                         f"the chunk {chunk}")

    def heads(w):
        return logical_shard(split_heads(x @ w, nh, hd), "batch", None,
                             "heads", None)

    q = heads(p["w_q"]).float() / math.sqrt(hd)
    k = heads(p["w_k"]).float() / math.sqrt(hd)
    v = heads(p["w_v"]).float()
    log_i = logical_shard((x @ p["w_i"]).float(), "batch", None, "heads")
    log_f = logical_shard(_logsigmoid((x @ p["w_f"]).float()), "batch",
                          None, "heads")
    C = n = None
    if state is not None:
        # fold a stabilized decode state back to raw scale (exp(m))
        scale = torch.exp(state["m"].float())
        C = state["C"].float() * scale[..., None, None]
        n = state["n"].float() * scale[..., None]
    h, C, n = _mlstm_local(q, k, v, log_i, log_f, C, n, chunk)
    h = h.reshape(b, s, nh * hd)
    y = logical_shard(h.to(x.dtype) @ p["w_out"], "batch", None, None)
    if return_state:
        final = {"C": C, "n": n,
                 "m": torch.zeros((b, nh), dtype=torch.float32,
                                  device=x.device)}
        return y, final
    return y


def mlstm_step(p: Dict, cfg: ModelConfig, x: torch.Tensor, state: Dict
               ) -> Tuple[torch.Tensor, Dict]:
    """One decode step with matrix memory. x: (B, 1, D)."""
    b, _, d = x.shape
    nh = cfg.n_heads
    hd = d // nh
    xt = x[:, 0]
    q = (xt @ p["w_q"]).reshape(b, nh, hd).float() / math.sqrt(hd)
    k = (xt @ p["w_k"]).reshape(b, nh, hd).float() / math.sqrt(hd)
    v = (xt @ p["w_v"]).reshape(b, nh, hd).float()
    log_i = (xt @ p["w_i"]).float()  # (B,H)
    log_f = _logsigmoid((xt @ p["w_f"]).float())
    m_prev = state["m"]
    m = torch.maximum(log_f + m_prev, log_i)
    f_s = torch.exp(log_f + m_prev - m)[..., None]
    i_s = torch.exp(log_i - m)[..., None]
    C = (f_s[..., None] * state["C"]
         + i_s[..., None] * (k[..., :, None] * v[..., None, :]))
    n = f_s * state["n"] + i_s * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", q, n).abs(),
                        torch.exp(-m))
    h = (num / den[..., None]).reshape(b, 1, nh * hd)
    y = h.to(x.dtype) @ p["w_out"]
    return y, {"C": C, "n": n, "m": m}


def init_mlstm_state(cfg: ModelConfig, batch: int,
                     device: Optional[torch.device] = None) -> Dict:
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    return {
        "C": torch.zeros((batch, nh, hd, hd), dtype=torch.float32,
                         device=device),
        "n": torch.zeros((batch, nh, hd), dtype=torch.float32, device=device),
        "m": torch.full((batch, nh), -30.0, dtype=torch.float32,
                        device=device),
    }
