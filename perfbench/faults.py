"""Faults planted under the timed path, for the checks that the
comparison fails them: on the CPU in the tests, on the chip by
``calibrate.py`` at the cell's own size.

Each is a context manager around a run or a :class:`train_cell.Loop`:

- ``unchanged``: the optimizer returns the state as it was given (the
  gradient norm and learning rate still reported);
- ``half_batch``: each step takes the first half of its rows and
  micro-batches, the mean over those;
- ``double_leaf``: the update of one leaf (the head) is applied twice;
- ``no_clip``: the optimizer skips the global-norm clip.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch


@contextlib.contextmanager
def _patched_update(fn):
    from repro_torch.runtime import steps
    orig = steps.adamw_update
    steps.adamw_update = fn(orig)
    try:
        yield
    finally:
        steps.adamw_update = orig


def unchanged():
    def make(orig):
        @torch.no_grad()
        def update(cfg, params, grads, state):
            from repro_torch.optim.adamw import cosine_schedule, global_norm
            return params, state, {
                "grad_norm": global_norm(grads),
                "lr": cosine_schedule(cfg, state["step"] + 1)}
        return update
    return _patched_update(make)


def double_leaf():
    def make(orig):
        @torch.no_grad()
        def update(cfg, params, grads, state):
            before = params["head"].clone()
            out = orig(cfg, params, grads, state)
            params["head"].add_(params["head"] - before)
            return out
        return update
    return _patched_update(make)


def no_clip():
    def make(orig):
        def update(cfg, params, grads, state):
            return orig(dataclasses.replace(cfg, grad_clip=0.0), params,
                        grads, state)
        return update
    return _patched_update(make)


@contextlib.contextmanager
def half_batch():
    from perfbench import train_cell
    from repro_torch.runtime.steps import build_train_step
    orig_init = train_cell.Loop.__init__

    def init(self, model, traffic, seed, device, step_fn=None):
        orig_init(self, model, traffic, seed, device, step_fn)
        half = build_train_step(self.cfg, self.opt_cfg,
                                max(traffic["n_micro"] // 2, 1))

        def step(state, batch):
            rows = batch["tokens"].shape[0] // 2
            return half(state, {k: v[:rows] for k, v in batch.items()})
        self.step_fn = step

    train_cell.Loop.__init__ = init
    try:
        yield
    finally:
        train_cell.Loop.__init__ = orig_init


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "double_leaf": double_leaf, "no_clip": no_clip}
