"""The plain reference of a training cell: the same steps on the same
inputs in plain PyTorch, float32, with TF32 off.

It draws the weights and batches again from the seed (``inputs``), runs
the configuration's layers from ``families/<family>.py`` and the
optimizer written out here (AdamW with the global-norm clip and the
warm-up and cosine schedule), and returns the readings that ``judge``
compares: each step's loss, the global gradient norm of the first step,
each leaf's norm of the first gradient as the optimizer applies it (after
the clip), and each leaf's norm of the change of its parameters after the
steps.  A leaf is one weight of one layer.  The loss of a micro-batch is
the family's cross entropy plus its ``AUX_WEIGHT`` x the auxiliary terms
its layers return, as the program's loss is.

It keeps the configuration's storage: parameters are rounded to their
leaf's type (``param_dtype``, or the type its spec names) after each
update, moments and the gradient sum are float32.  It is computed layer
by layer, so that it fits beside its own state: the forward keeps each
layer's input, and the backward runs each layer again under autograd,
from the last layer down.  Nothing here imports the program.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch

from . import inputs

Cast = Callable[[torch.Tensor], torch.Tensor]
LAYER = "layers."
# the steps of every training cell that the comparison follows
CHECKED_STEPS = 2


def no_cast(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8_cast(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the tensor (its
    largest magnitude at 448), the gradient passed straight through: the
    products of an fp8 training step, the precision below bfloat16."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    low = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (low - t.detach())


def leaf_names(model: dict) -> List[str]:
    """The leaves compared, top-level ones by their names and per-layer
    ones as ``layers.<i>.<name>``, in a fixed order."""
    out = []
    for name, shape, *_ in inputs.leaf_specs(model):
        if name.startswith(LAYER):
            out += [f"{LAYER}{i}.{name[len(LAYER):]}" for i in range(shape[0])]
        else:
            out.append(name)
    return out


def _split(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Stacked per-layer weights as one clone a layer, under the names
    of :func:`leaf_names`."""
    out = {}
    for name, t in weights.items():
        if name.startswith(LAYER):
            for i in range(t.shape[0]):
                out[f"{LAYER}{i}.{name[len(LAYER):]}"] = t[i].clone()
        else:
            out[name] = t
    return out


def lr_at(opt: dict, step: int) -> float:
    """Linear warm-up over ``warmup_steps``, then a cosine decay to
    ``min_lr_frac`` of ``lr`` at ``total_steps`` (1-based steps)."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    t = min(max((step - opt["warmup_steps"])
                / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * t))
    return opt["lr"] * warm * (opt["min_lr_frac"]
                               + (1.0 - opt["min_lr_frac"]) * cos)


class Reference:
    """The reference's training state for one cell and seed."""

    def __init__(self, model: dict, traffic: dict, seed: int,
                 device: torch.device, cast: Cast = no_cast):
        self.model, self.traffic, self.seed = model, traffic, seed
        self.device, self.cast = device, cast
        self.fam = inputs.family(model)
        self.params = _split(inputs.make_weights(model, seed, device))
        self.names = leaf_names(model)
        self.m = {k: torch.zeros_like(v, dtype=torch.float32)
                  for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v, dtype=torch.float32)
                  for k, v in self.params.items()}
        self.step = 0

    def layer(self, i: int, grad: bool) -> Dict[str, torch.Tensor]:
        prefix = f"{LAYER}{i}."
        return {k[len(prefix):]: v.detach().float().requires_grad_(grad)
                for k, v in self.params.items() if k.startswith(prefix)}

    def micro_batch(self, tokens: torch.Tensor, labels: torch.Tensor,
                    acc: Dict[str, torch.Tensor]) -> float:
        """Add one micro-batch's gradients into ``acc``; its loss.  Each
        layer's backward takes the gradient of its output and its
        auxiliary term's weight, so that the walk gives the gradient of
        ``ce + AUX_WEIGHT x`` the sum of the layers' terms."""
        model, fam = self.model, self.fam
        n = model["n_layers"]
        xs, aux = [], []
        with torch.no_grad():
            x = fam.embed(self.params, tokens)
            for i in range(n):
                xs.append(x)
                x, a = fam.block(model, x, self.layer(i, False), self.cast, i)
                if a is not None:
                    aux.append(a)
        x.requires_grad_()
        top = {k: self.params[k].detach().float().requires_grad_()
               for k in self.names if not k.startswith(LAYER)
               and k != "embed"}
        loss = fam.loss(model, x, top, labels)
        loss.backward()
        for k, t in top.items():
            acc[k] += t.grad
        dx = x.grad
        del x, top
        for i in reversed(range(n)):
            xin = xs.pop().requires_grad_()
            lp = self.layer(i, True)
            y, a = fam.block(model, xin, lp, self.cast, i)
            outs, grads = [y], [dx]
            if a is not None:
                outs.append(a)
                grads.append(torch.full_like(a, fam.AUX_WEIGHT))
            torch.autograd.backward(outs, grads)
            for k, t in lp.items():
                acc[f"{LAYER}{i}.{k}"] += t.grad
            dx = xin.grad
            del xin, lp, y, a, outs, grads
        acc["embed"].index_add_(0, tokens.reshape(-1),
                                dx.reshape(-1, dx.shape[-1]))
        loss = loss.detach()
        if aux:
            loss = loss + fam.AUX_WEIGHT * sum(aux)
        return float(loss)

    def train_step(self, batch: Dict[str, torch.Tensor]) -> dict:
        """One step of ``n_micro`` micro-batches: the mean of their losses
        and gradients, the clip, the update.  Returns the loss, the global
        gradient norm before the clip and each leaf's clipped gradient
        norm."""
        opt = self.traffic["optimizer"]
        n_micro = self.traffic["n_micro"]
        rows = batch["tokens"].shape[0] // n_micro
        acc = {k: torch.zeros_like(v, dtype=torch.float32)
               for k, v in self.params.items()}
        losses = []
        for j in range(n_micro):
            sl = slice(j * rows, (j + 1) * rows)
            losses.append(self.micro_batch(batch["tokens"][sl],
                                           batch["labels"][sl], acc))
        for g in acc.values():
            g.div_(n_micro)
        gnorm = math.sqrt(sum(float(g.double().square().sum())
                              for g in acc.values()))
        scale = min(1.0, opt["grad_clip"] / max(gnorm, 1e-9))
        self.step += 1
        lr = lr_at(opt, self.step)
        b1, b2 = opt["b1"], opt["b2"]
        b1c, b2c = 1.0 - b1 ** self.step, 1.0 - b2 ** self.step
        norms = {}
        for k in self.names:
            g = acc.pop(k).mul_(scale)
            norms[k] = float(g.norm())
            m, v, p = self.m[k], self.v[k], self.params[k]
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).add_(g.square(), alpha=1.0 - b2)
            delta = (m / b1c) / ((v / b2c).sqrt() + opt["eps"])
            p32 = p.float()
            delta.add_(p32, alpha=opt["weight_decay"])
            p.copy_(p32.sub_(delta, alpha=lr))
            del g, delta, p32
        return {"loss": sum(losses) / n_micro, "grad_norm": gnorm,
                "leaf_grad_norms": norms}

    def change_norms(self) -> Dict[str, float]:
        """Each leaf's norm of its parameters' change since the start,
        the start drawn again from the seed one leaf at a time."""
        out = {}
        for spec in inputs.leaf_specs(self.model):
            p0 = inputs.make_leaf(self.model, self.seed, spec, self.device)
            name = spec[0]
            if name.startswith(LAYER):
                for i in range(p0.shape[0]):
                    k = f"{LAYER}{i}.{name[len(LAYER):]}"
                    out[k] = float((self.params[k].float()
                                    - p0[i].float()).norm())
            else:
                out[name] = float((self.params[name].float()
                                   - p0.float()).norm())
            del p0
        return out


def readings(model: dict, traffic: dict, seed: int, device: torch.device,
             cast: Cast = no_cast) -> dict:
    """The reference's readings over the first ``CHECKED_STEPS`` steps."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = Reference(model, traffic, seed, device, cast)
        losses, first = [], None
        for step in range(CHECKED_STEPS):
            host = inputs.make_batch(model, traffic, seed, step)
            batch = {k: torch.as_tensor(v, device=device)
                     for k, v in host.items()}
            out = ref.train_step(batch)
            losses.append(out["loss"])
            first = first or out
        return {"losses": losses, "grad_norm": first["grad_norm"],
                "leaf_grad_norms": first["leaf_grad_norms"],
                "leaf_change_norms": ref.change_norms()}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
