"""Plain PyTorch versions of the port's kernels (the allclose targets).

Each function computes what its hand-written CUDA kernel computes, with
ordinary tensor operations on whatever device its inputs lie on.  The
kernels' wrappers take these for CPU tensors, the CPU tests hold them
against the JAX package's oracles, and the chip smoke test holds each
kernel against them on the card.  The Metronome kernels are float32
throughout; attention accumulates in float32 and returns q's dtype, the
RG-LRU recurrence carries a float32 state and returns x's dtype, the LM
head's products are float32 products of upcast operands.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.float32)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  sm_scale: Optional[float] = None, return_lse: bool = False):
    """Naive full-softmax GQA attention. q: (B,H,S,D), k/v: (B,Hkv,S,D).

    q head h reads kv head h // (H // Hkv); masked scores take -1e30;
    ``window`` > 0 keeps q_pos - k_pos < window.  With ``return_lse`` it
    also returns each row's logsumexp of the masked, scaled scores,
    float32 (B, H, S) in natural-log units, what the backward reads."""
    s = _masked_scores(q, k, causal, window, sm_scale)
    p = torch.softmax(s, dim=-1)
    g = q.shape[1] // v.shape[1]
    o = torch.einsum("bhqk,bhkd->bhqd", p,
                     v.repeat_interleave(g, dim=1).float()).to(q.dtype)
    return (o, torch.logsumexp(s, dim=-1)) if return_lse else o


def _masked_scores(q, k, causal: bool, window: int,
                   sm_scale: Optional[float]) -> torch.Tensor:
    """float32 (B, H, S, S) scores q.k * scale, -1e30 where masked."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    kr = k.repeat_interleave(h // hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    return s.masked_fill(~mask, -1e30)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            sm_scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(dq, dk, dv) of :func:`attention_ref` for upstream gradient ``do``,
    from its output ``o`` and row logsumexp ``lse``, by the explicit
    formulas in float32: P = exp(S scale - lse), delta = rowsum(dO o O),
    dV = sum over the group of P^T dO, dP = dO V^T, dS = P o (dP - delta),
    dQ = scale dS K, dK = scale sum over the group of dS^T Q (S the raw
    scores, masked ones -1e30 as in :func:`attention_ref`).  Each gradient
    in its input's dtype."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qf, dof = q.float(), do.float()
    kr = k.repeat_interleave(g, dim=1).float()
    vr = v.repeat_interleave(g, dim=1).float()
    p = torch.exp(_masked_scores(q, k, causal, window, sm_scale)
                  - lse.float()[..., None])
    delta = (dof * o.float()).sum(dim=-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vr) - delta[..., None])
    del p
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale

    def group_sum(t):
        return t.reshape(b, hkv, g, s, d).sum(dim=2)

    return dq.to(q.dtype), group_sum(dk).to(k.dtype), \
        group_sum(dv).to(v.dtype)


def lm_head_fwd_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The LM head's logits (T, V) float32 = x (T, d) . w (d, V), both
    upcast to float32: the expression ``models.model._logits`` keeps for
    operands the kernels do not take."""
    return x.float() @ w.float()


def bf16x3_split_ref(a: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The head's backward kernels' split of float32 ``a`` into three
    bfloat16 tensors: hi = bf16(a), mid = bf16(a - hi), lo = bf16(a - hi -
    mid), each subtraction in float32 (where it is exact), so that hi +
    mid + lo is a exactly wherever lo does not fall below bfloat16's
    normal range."""
    a = a.float()
    hi = a.to(torch.bfloat16)
    r = a - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def lm_head_dx_ref(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The head's input gradient (T, d) in w's dtype from the logits'
    float32 gradient ``g`` (T, V): autograd's float32 product through
    ``lm_head_fwd_ref``, then the cast to the input's type."""
    return g.float().mm(w.float().t()).to(w.dtype)


def lm_head_dw_ref(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The head's weight gradient (d, V) in x's dtype: autograd's float32
    product x^T . g through ``lm_head_fwd_ref``, then the cast."""
    return x.float().t().mm(g.float()).to(x.dtype)


def rg_lru_ref(a: torch.Tensor, x: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Linear recurrence oracle: y_t = a_t * y_{t-1} + x_t over (B, S, W),
    one step at a time with a float32 state."""
    b, s, w = x.shape
    h = (torch.zeros((b, w), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    af, xf = a.float(), x.float()
    ys = torch.empty((b, s, w), dtype=torch.float32, device=x.device)
    for t in range(s):
        h = af[:, t] * h + xf[:, t]
        ys[:, t] = h
    return ys.to(x.dtype)


def rg_lru_bwd_ref(a: torch.Tensor, y: torch.Tensor, g: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradient of :func:`rg_lru_ref` from a zero state, an explicit
    reverse loop: for upstream gradient g and output y, d_{S-1} = g_{S-1},
    d_t = g_t + a_{t+1} * d_{t+1}; returns (da, dx) with dx_t = d_t and
    da_t = d_t * y_{t-1}, y_{-1} = 0.  Each step rounds as autograd through
    the forward loop does, so the two agree bit for bit."""
    b, s, w = g.shape
    af, yf, gf = a.float(), y.float(), g.float()
    da = torch.empty((b, s, w), dtype=torch.float32, device=g.device)
    dx = torch.empty((b, s, w), dtype=torch.float32, device=g.device)
    d = gf[:, s - 1]
    for t in range(s - 1, -1, -1):
        if t < s - 1:
            d = gf[:, t] + af[:, t + 1] * d
        dx[:, t] = d
        da[:, t] = d * (yf[:, t - 1] if t > 0 else torch.zeros_like(d))
    return da.to(a.dtype), dx.to(y.dtype)


def metronome_score_ref(base_demand, bank_a, bank_b,
                        capacity: float) -> torch.Tensor:
    """Pairwise rotation-score enumeration oracle.

    base_demand: (S,) demand of all FIXED tasks (already rotated).
    bank_a:      (Ra, S) demand of free task A at every candidate rotation.
    bank_b:      (Rb, S) demand of free task B at every candidate rotation.
    Returns scores (Ra, Rb) per Eq. 18, scaled to [0, 100]: the single-link
    case of :func:`metronome_score_multilink_ref`.
    """
    base = _f32(base_demand)
    caps = torch.full((1,), float(capacity), dtype=torch.float32,
                      device=base.device)
    return metronome_score_multilink_ref(
        base[None], _f32(bank_a)[None], _f32(bank_b)[None], caps)


def metronome_score_multilink_ref(base_demand, bank_a, bank_b,
                                  capacities) -> torch.Tensor:
    """Multi-link joint rotation-score oracle.

    base_demand: (L, S) demand of all FIXED jobs per link (already rotated).
    bank_a:      (L, Ra, S) demand of free job A per link at every rotation.
    bank_b:      (L, Rb, S) demand of free job B per link at every rotation.
    capacities:  (L,) per-link allocatable bandwidth.
    Returns (Ra, Rb): min over links of the per-link Eq. 18 score.
    """
    return metronome_score_multilink_batch_ref(
        _f32(base_demand)[None], _f32(bank_a)[None], _f32(bank_b)[None],
        _f32(capacities)[None])[0]


def metronome_score_multilink_batch_ref(base_demand, bank_a, bank_b,
                                        capacities) -> torch.Tensor:
    """Candidate-batched multi-link joint rotation-score oracle.

    base_demand: (C, L, S) fixed demand per candidate placement and link.
    bank_a:      (C, L, Ra, S) free job A's demand bank per candidate/link.
    bank_b:      (C, L, Rb, S) free job B's demand bank per candidate/link.
    capacities:  (C, L) per-candidate per-link allocatable bandwidth.
    Returns (C, Ra, Rb): per candidate, the min over its links of the
    per-link Eq. 18 score.  Zero-demand unit-capacity padding links score
    exactly 100 and never change the min.
    """
    base = _f32(base_demand)
    dev = base.device
    a = _f32(bank_a, dev)
    b = _f32(bank_b, dev)
    caps = _f32(capacities, dev)
    s = base.shape[-1]
    total = (base[:, :, None, None, :] + a[:, :, :, None, :]
             + b[:, :, None, :, :])  # (C, L, Ra, Rb, S)
    excess = torch.clamp_min(
        total - caps[:, :, None, None, None], 0.0).sum(dim=-1)
    frac = excess / (caps[:, :, None, None] * s)
    return torch.clamp_min(100.0 * (1.0 - frac.amax(dim=1)), 0.0)


# float32 analogue of the fluid engine's 1e-9 freeze threshold: link
# capacities are O(25-200) Gbps where the f32 ulp is ~1.5e-5, so a 1e-4
# saturation band keeps every "link just drained" round from ping-ponging
# on rounding residue (core/fluid.py keeps 1e-9 under float64)
FILL_EPS = 1e-4
_FILL_INF = 1e30


def progressive_fill_ref(demands, routes, caps) -> torch.Tensor:
    """Batched progressive-filling max-min fairness oracle.

    demands: (B, F) per-flow demand caps.
    routes:  (B, F, L) 0/1 route matrix — flow f crosses link l (any dtype).
    caps:    (B, L) per-link capacity.
    Returns rates (B, F), float32, on the inputs' device.

    Every unfrozen flow grows by the common increment (the min over
    per-flow headroom and per-link remaining/active-count), then flows
    freeze on demand met or a saturated path link.  Each round freezes at
    least one flow per unfinished problem, so F + 1 rounds always suffice;
    the loop exits as soon as every problem in the batch has drained.
    Padding discipline: zero-demand flows never activate, zero-route
    unit-capacity links never saturate.
    """
    return _fill_rounds(demands, routes, caps)[0]


def _fill_rounds(demands, routes, caps) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`progressive_fill_ref` plus the number of rounds each problem
    ran before it drained, (B,) int64 (what the fill kernel's loop does on
    these inputs)."""
    d = _f32(demands)
    dev = d.device
    r = _f32(routes, dev)
    rem = _f32(caps, dev)
    b, f = d.shape
    rates = torch.zeros_like(d)
    act = (d > FILL_EPS).to(torch.float32)
    rounds = torch.zeros(b, dtype=torch.int64, device=dev)
    for _ in range(f + 1):
        live = act.amax(dim=1) > 0.5  # (B,)
        if not bool(live.any()):
            break
        rounds += live.to(torch.int64)
        counts = torch.einsum("bfl,bf->bl", r, act)  # (B, L)
        ratio = torch.where(counts > 0.5, rem / torch.clamp_min(counts, 1.0),
                            torch.full_like(rem, _FILL_INF))
        head = torch.where(act > 0.5, d - rates, torch.full_like(d, _FILL_INF))
        inc = torch.clamp_min(torch.minimum(ratio.amin(dim=1),
                                            head.amin(dim=1)), 0.0)
        inc = torch.where(live, inc, torch.zeros_like(inc))  # drained rows
        rates = rates + inc[:, None] * act
        rem = rem - inc[:, None] * counts
        sat = (rem <= FILL_EPS).to(torch.float32)  # (B, L)
        blocked = torch.einsum("bfl,bl->bf", r, sat) > 0.5
        met = rates >= d - FILL_EPS
        act = torch.where(met | blocked, torch.zeros_like(act), act)
    return rates, rounds
