"""The yardstick: the chip's peaks, and the work of a training step and of
an attention launch counted from shapes alone.

The rules are those of the program's bring-up script (``chip_smoke.py``:
``_train_flops``, ``_unmasked_pairs``, the flash bounds), copied here so
that no later change to the program can move them.  The work is counted
from the shapes a call was given, so it reads the same whatever kernel
runs the call.
"""
from __future__ import annotations

from typing import Iterable, List

import numpy as np

# NVIDIA H100 SXM5 80GB, NVIDIA's data sheet: dense bf16 tensor-core rate
# and HBM3 bandwidth, at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

# operations a (q, k) pair costs per head dimension: the forward's Q.K^T
# and P.V (a multiply and an add each); the backward's five products (S
# again, dP, dV, dQ and dK), not any implementation's recompute
FWD_OPS_PER_PAIR_DIM = 4
BWD_OPS_PER_PAIR_DIM = 10


def unmasked_pairs(s: int, causal: bool, window: int) -> int:
    """(q, k) pairs of one head that the causal and window masks leave,
    for a sequence of ``s`` tokens (``window`` 0: no window)."""
    i = np.arange(s, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros_like(i)
    hi = i + 1 if causal else np.full_like(i, s)
    return int(np.sum(hi - lo))


def token_weights(specs: Iterable[tuple], routed: Iterable[str] = (),
                  top_k: int = 1, n_experts: int = 1) -> int:
    """Weight elements one token's products pass through, from the leaf
    specs (``(name, shape, ...)``): every leaf but the embedding table
    (``embed``, a lookup), the routed experts' leaves (names in
    ``routed``) at ``top_k / n_experts`` of the experts held here, since a
    token is sent to ``top_k`` of all ``n_experts`` (floored to a whole
    element).  Counted from the configuration: capacity drops and the
    routing measured in a run play no part."""
    routed = set(routed)
    sizes = {spec[0]: int(np.prod(spec[1])) for spec in specs}
    held = sum(n for name, n in sizes.items() if name in routed)
    rest = sum(n for name, n in sizes.items()
               if name not in routed and name != "embed")
    return rest + held * top_k // n_experts


def train_step_flops(weights: int, windows: List[int], model: dict,
                     seq: int, seqs: int) -> int:
    """Model FLOPs of one training step, no remat: 6 x the ``weights``
    one token passes through (:func:`token_weights`) x the tokens, plus
    12 D H per unmasked (q, k) pair of each causal attention layer of each
    sequence (Q.K^T and P.V, forward and backward), the layers' windows
    given in ``windows`` (0: none)."""
    pairs = sum(unmasked_pairs(seq, True, w) for w in windows)
    attn = 12 * head_dim(model) * model["n_heads"] * pairs * seqs
    return 6 * weights * seq * seqs + attn


def head_dim(model: dict) -> int:
    return model.get("d_head") or model["d_model"] // model["n_heads"]


def attention_bound_s(call: dict, backward: bool) -> float:
    """The least time one attention launch could take on the chip: the
    larger of its operations over the bf16 peak and its bytes, each input
    read once and each output written once, over the HBM bandwidth.

    ``call`` holds the launch's shapes: ``b``, ``h``, ``hkv``, ``s``,
    ``d``, ``causal``, ``window`` and the operands' ``itemsize``.  The
    forward reads q, k and v and writes o and the rows' float32
    logsumexp; the backward reads those five and dO and writes dQ, dK and
    dV."""
    b, h, hkv, s, d = (call[k] for k in ("b", "h", "hkv", "s", "d"))
    pairs = unmasked_pairs(s, call["causal"], call["window"])
    per_dim = BWD_OPS_PER_PAIR_DIM if backward else FWD_OPS_PER_PAIR_DIM
    ops = b * h * pairs * per_dim * d
    q = b * h * s * d * call["itemsize"]
    kv = b * hkv * s * d * call["itemsize"]
    lse = b * h * s * 4
    if backward:
        moved = 2 * (q + 2 * kv) + 2 * q + lse  # q k v o lse dO; dq dk dv
    else:
        moved = q + 2 * kv + q + lse  # q k v; o lse
    return max(ops / PEAK_BF16_FLOPS, moved / PEAK_HBM_BYTES_PER_S)
