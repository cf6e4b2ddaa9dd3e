"""The train step with gradient accumulation, and the serving steps (the
JAX package's ``runtime/steps.py``).

``build_train_step`` returns a function ``(state, batch) -> (state,
metrics)`` that splits the global batch into micro-batches (bounded
activation memory), accumulates their gradients in ``accum_dtype`` and
applies AdamW.  Gradients come from ``torch.autograd.grad`` over the
parameter leaves.  All tensors carry logical-axis sharding constraints:
with DTensor parameters (``sharding.shard_tree``) under
``sharding.use_rules(mesh)`` the step runs sharded over the mesh; with
plain parameters the constraints do nothing and it runs on one device.

While a ``torch.profiler`` records, a train step marks its work with spans
(``_spans.span``): ``repro_torch.train_step.forward`` around each
micro-batch's slice and loss; ``repro_torch.train_step.backward`` around
each micro-batch's ``torch.autograd.grad`` (the remat recompute included)
and its gradients' constraints; ``repro_torch.train_step.accumulate``
around each stretch that makes or changes the float32 gradient sum (the
buffers, each micro-batch's adds and loss sums, the division and the int8
round trip).  AdamW adds its own (``optim/adamw.py``).  The benchmark's
``forward_ms``, ``backward_ms``, ``grad_accum_ms`` and ``optimizer_ms``
read them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple, Union

import torch

from ..models import (COUNTERS, decode_step, init_model, join_counters,
                      loss_fn, prefill)
from ..models.config import ModelConfig, ShapeConfig
from ..optim import AdamWConfig, adamw_init, adamw_update, quantize_int8
from ..sharding import (best_spec, current_rules, distribute, logical_shard,
                        spec_leaves)
from ..sharding.local import is_dtensor
from .._spans import span
from .._tree import leaves, rebuild

FORWARD_SPAN = "repro_torch.train_step.forward"
BACKWARD_SPAN = "repro_torch.train_step.backward"
ACCUMULATE_SPAN = "repro_torch.train_step.accumulate"


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Dict
    step: torch.Tensor


def make_train_state_specs(cfg: ModelConfig, param_specs) -> TrainState:
    """Logical specs for the TrainState (opt moments shard like params)."""
    return TrainState(
        params=param_specs,
        opt={"m": param_specs, "v": param_specs, "step": ()},
        step=(),
    )


def auto_microbatches(cfg: ModelConfig, shape: ShapeConfig,
                      n_data_shards: int) -> int:
    """Pick a microbatch count keeping ~<=2 sequences x 4k tokens per data
    shard per microbatch (activation-memory heuristic; perf loop can tune)."""
    if shape.microbatch:
        return max(1, shape.global_batch // shape.microbatch)
    tokens_per_seq = shape.seq_len
    seqs_per_shard = shape.global_batch / max(n_data_shards, 1)
    budget = max(1.0, 8192.0 / tokens_per_seq)  # seqs per shard per micro
    n_micro = int(max(1, round(seqs_per_shard / budget)))
    # n_micro must divide global batch
    while shape.global_batch % n_micro:
        n_micro += 1
    return n_micro


def _micro_slice(x: torch.Tensor, i: int, n_micro: int) -> torch.Tensor:
    if x.dim() == 0:
        return x
    # positions for mrope have shape (3, B, S): batch on axis 1
    axis = 1 if x.dim() == 3 and x.shape[0] == 3 else 0
    b = x.shape[axis] // n_micro
    return x.narrow(axis, i * b, b)


def build_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    n_micro: int = 1,
    accum_dtype: Any = torch.float32,
    param_specs: Any = None,
    compress_grads: bool = False,
) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    Each micro-batch's gradients are added into ``accum_dtype`` buffers in
    place and freed before the next micro-batch; the sum is divided by
    ``n_micro``, optionally int8 quantize-dequantized (``compress_grads``:
    the numerics of sending the cross-pod all-reduce at int8), and applied
    by AdamW, which updates ``state``'s parameters and moments in place.
    Metrics: ``loss``, ``aux``, ``grad_norm`` and ``lr``, float32 tensors
    on the parameters' device, and the counters the loss reports
    (``models.COUNTERS``), joined over the micro-batches.

    The batch is constrained to ("batch", ...): with DTensor parameters a
    plain batch (the global batch, alike on every rank) becomes a DTensor
    sharded that way.  ``param_specs`` (the logical-axis tree of
    ``models.logical_specs``) re-constrains each micro-batch's gradients
    to the parameter sharding right after autodiff, so that a DTensor
    gradient is reduce-scattered to its parameter's layout instead of
    all-reduced."""
    spec_list = None if param_specs is None else spec_leaves(param_specs)

    def _constrain_grads(grads):
        if spec_list is None:
            return grads
        return [g if g is None else logical_shard(g, *sp)
                for g, sp in zip(grads, spec_list)]

    def constrain(name, x, dtensor_params):
        if x.dim() < 2:
            return x
        logical = ("batch",) + (None,) * (x.dim() - 1)
        if name == "positions":  # M-RoPE (3, B, S): batch on axis 1
            logical = (None, "batch", None)
        rules = current_rules()
        if dtensor_params and rules is not None and not is_dtensor(x):
            return distribute(x, best_spec(x.shape, logical, rules),
                              rules.mesh)
        return logical_shard(x, *logical)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        params = leaves(state.params)
        dtensor_params = is_dtensor(params[0])
        batch = {k: constrain(k, v, dtensor_params) for k, v in batch.items()}
        with span(ACCUMULATE_SPAN):
            grads = [torch.zeros_like(p, dtype=accum_dtype,
                                      memory_format=torch.contiguous_format)
                     for p in params]
        # 0 + x is x: the sums start from the first micro-batch's values,
        # which are DTensors when the parameters are
        loss_sum = aux_sum = 0.0
        counters: Dict[str, torch.Tensor] = {}
        for i in range(n_micro):
            with span(FORWARD_SPAN):
                xs = [p.detach().requires_grad_() for p in params]
                # DTensor gathers a sharded batch's rows to slice them: the
                # slice is sharded again
                mb = {k: constrain(k, _micro_slice(v, i, n_micro),
                                   dtensor_params) for k, v in batch.items()}
                loss, metrics = loss_fn(rebuild(state.params, xs), cfg, mb)
            with span(BACKWARD_SPAN):
                g = _constrain_grads(
                    torch.autograd.grad(loss, xs, allow_unused=True))
            del xs
            with torch.no_grad(), span(ACCUMULATE_SPAN):
                for acc, gi in zip(grads, g):
                    if gi is not None:
                        acc.add_(gi)
                del g
                loss_sum = loss_sum + loss.detach()
                aux_sum = aux_sum + metrics["aux"].detach()
                counters = join_counters(counters, {
                    k: v.detach() for k, v in metrics.items()
                    if k in COUNTERS})
            del loss, metrics
        with torch.no_grad(), span(ACCUMULATE_SPAN):
            for acc in grads:
                acc.div_(n_micro)
            if compress_grads:
                for acc in grads:
                    q, scale = quantize_int8(acc)
                    acc.copy_(q.float() * scale)
                    del q
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, state.params, rebuild(state.params, grads), state.opt)
        del grads
        metrics = {"loss": loss_sum / n_micro, "aux": aux_sum / n_micro,
                   **counters, **opt_metrics}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step


def build_serve_step(cfg: ModelConfig) -> Callable:
    """Returns serve_step(params, cache, tokens) -> (logits, cache) — one
    decode step against the KV cache / recurrent state."""

    def serve_step(params, cache, tokens):
        return decode_step(params, cfg, cache, tokens)

    return serve_step


def build_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(params, batch):
        return prefill(params, cfg, batch["tokens"],
                       positions=batch.get("positions"),
                       frames=batch.get("frames"))
    return prefill_step


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig,
                     generator: torch.Generator,
                     device: Union[str, torch.device] = "cuda") -> TrainState:
    """Parameters from :func:`~repro_torch.models.init_model` on
    ``device``, zero AdamW moments and step 0.  (The JAX package also
    returns the parameters' logical sharding specs; the port's are
    :func:`~repro_torch.models.logical_specs`.)"""
    params = init_model(cfg, generator, device)
    opt = adamw_init(opt_cfg, params)
    step = torch.zeros((), dtype=torch.int32, device=opt["step"].device)
    return TrainState(params, opt, step)
