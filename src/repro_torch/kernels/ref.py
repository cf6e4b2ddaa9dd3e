"""Plain PyTorch versions of the Metronome kernels (the allclose targets).

Each function computes what its hand-written CUDA kernel computes, with
ordinary tensor operations on whatever device its inputs lie on.  The
kernels' wrappers take these for CPU tensors, the CPU tests hold them
against the JAX package's oracles, and the chip smoke test holds each
kernel against them on the card.  Everything is float32, as the kernels
are.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.float32)


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
