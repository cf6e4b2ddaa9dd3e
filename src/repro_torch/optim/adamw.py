"""AdamW over the port's parameter trees (the JAX package's
``optim/adamw.py``).

Moments can be held in bf16 (``moment_dtype``); the update math always
runs in float32, with the JAX package's order of roundings, and the
schedule and bias corrections are float32 tensors as there.  Unlike the
JAX package, :func:`adamw_update` updates the parameters and moments in
place, leaf by leaf, freeing each leaf's float32 temporaries before the
next: at full width the embedding and head leaves are 655 M elements each
(2.6 GB apiece in float32), and a second copy of the state would not fit
beside the first.

While a ``torch.profiler`` records, :func:`adamw_update` runs inside the
span ``repro_torch.adamw.update`` (``_spans.span``): the global norm, the
clip, the schedule, the moments and the parameters.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from .._spans import span
from .._tree import leaves, tree_map

UPDATE_SPAN = "repro_torch.adamw.update"


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: Any = torch.float32  # bf16 for very large models
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up then cosine decay to ``min_lr_frac``, as a float32
    tensor on ``step``'s device."""
    step = torch.as_tensor(step)
    dev = step.device
    step = step.to(torch.float32)
    warm = torch.minimum(step / max(cfg.warmup_steps, 1), _f32(1.0, dev))
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi, dev) * t))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_init(cfg: AdamWConfig, params) -> Dict:
    def zeros(p):  # a DTensor's moments are DTensors laid out as it is
        return torch.zeros_like(p, dtype=cfg.moment_dtype,
                                memory_format=torch.contiguous_format)
    step = torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": step}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares."""
    sums = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state
                 ) -> Tuple[Any, Dict, Dict]:
    """One AdamW step.  Returns (params, state, {"grad_norm", "lr"}): the
    parameters and the moments are the given tensors, updated in place;
    the step counter is a new tensor."""
    with span(UPDATE_SPAN):
        return _update(cfg, params, grads, state)


def _update(cfg, params, grads, state):
    step = state["step"] + 1
    gnorm = global_norm(grads)
    if cfg.grad_clip > 0:
        scale = torch.minimum(_f32(1.0, gnorm.device),
                              cfg.grad_clip / torch.clamp_min(gnorm, 1e-9))
    else:
        scale = _f32(1.0, gnorm.device)
    lr = cosine_schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(_f32(cfg.b1, stepf.device), stepf)
    b2c = 1.0 - torch.pow(_f32(cfg.b2, stepf.device), stepf)

    for p, g, m, v in zip(leaves(params), leaves(grads),
                          leaves(state["m"]), leaves(state["v"])):
        # the JAX package's expressions, each op rounded to float32 in its
        # order; out= and in-place ops reuse two leaf-sized temporaries
        g32 = g.float() * scale
        m32 = m if m.dtype == torch.float32 else m.float()
        v32 = v if v.dtype == torch.float32 else v.float()
        tmp = torch.mul(g32, 1 - cfg.b1)
        m32.mul_(cfg.b1).add_(tmp)                      # b1 m + (1-b1) g
        torch.square(g32, out=tmp).mul_(1 - cfg.b2)
        v32.mul_(cfg.b2).add_(tmp)                      # b2 v + (1-b2) g^2
        torch.div(v32, b2c, out=g32).sqrt_().add_(cfg.eps)
        torch.div(m32, b1c, out=tmp).div_(g32)          # mh / (sqrt vh + eps)
        p32 = p.float()
        tmp.add_(torch.mul(p32, cfg.weight_decay, out=g32))
        p.copy_(torch.sub(p32, tmp.mul_(lr), out=tmp))  # p - lr * delta
        if m32 is not m:
            m.copy_(m32)
            v.copy_(v32)
        del g32, m32, v32, tmp, p32
    return params, {"m": state["m"], "v": state["v"], "step": step}, {
        "grad_norm": gnorm, "lr": lr}
