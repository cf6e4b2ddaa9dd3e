"""Gradient compression for the cross-pod (DCN) all-reduce.

The data-parallel gradient all-reduce over pods is exactly the host-link
traffic Metronome schedules.  The JAX package's int8 error-feedback
compressor (per-tensor scale quantization with an error accumulator,
1-bit-Adam-style EF, 4x over fp32), op for op: ``torch.round`` rounds half
to even as ``jnp.round`` does, so the two agree bit for bit.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .._tree import tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    x32 = x.float()
    amax = x32.abs().max()
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def make_ef_state(grads) -> Dict:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                           device=g.device), grads)


def compress_ef_int8(grads, ef_state):
    """Error-feedback int8: compress (g + e), remember the residual.
    Returns ({leaf: (q, scale)}, new error state)."""
    def one(g, e):
        x = g.float() + e
        q, scale = quantize_int8(x)
        return (q, scale), x - q.float() * scale

    out = tree_map(one, grads, ef_state)
    qs = tree_map(lambda o: o[0], out)
    new_e = tree_map(lambda o: o[1], out)
    return qs, new_e


def decompress_ef_int8(qs):
    return tree_map(lambda q_scale: q_scale[0].float() * q_scale[1], qs)
