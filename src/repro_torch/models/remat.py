"""Recomputation of the training forward's blocks (``cfg.remat``).

Two policies, the JAX package's two:

  * ``"nothing"``: ``torch.utils.checkpoint`` keeps only a block's inputs
    and reruns the whole block in the backward pass (``nothing_saveable``);
  * ``"dots"``: selective checkpointing keeps the output of every product
    without batch dimensions and reruns everything else
    (``dots_with_no_batch_dims_saveable``).  Those products are each
    ``x @ W`` projection, which reaches ``aten.mm``, and the two einsums
    over a batch of one that reach ``aten.bmm``, the MoE router and the
    M-RoPE angles, which run inside :func:`unbatched_product`.  Batched
    products (attention, the MoE experts, the xLSTM chunks), norms, casts,
    elementwise ops, collectives and the allocations around a kernel's
    launch are rerun; a kernel launched through ctypes is never seen by
    the policy and reruns with its block.

The policy decides by op and by the flag :func:`unbatched_product` sets,
never by the tensor's type, so DTensor products are kept as plain ones.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Iterator

import torch
import torch.utils.checkpoint as ckpt

POLICIES = ("nothing", "dots")

_state = threading.local()


@contextlib.contextmanager
def unbatched_product() -> Iterator[None]:
    """Marks the products dispatched inside it as having no batch
    dimensions (an einsum that PyTorch runs as a ``bmm`` over a batch of
    one), for the ``"dots"`` policy to keep.  The flag is per thread: the
    backward's recompute sets it again on the thread that runs it."""
    _state.unbatched = True
    try:
        yield
    finally:
        _state.unbatched = False


def save_dots(ctx, op, *args, **kwargs) -> ckpt.CheckpointPolicy:
    """The ``"dots"`` policy for :func:`torch.utils.checkpoint.
    create_selective_checkpoint_contexts`: keep products without batch
    dimensions, recompute the rest."""
    if op is torch.ops.aten.mm.default or (
            op is torch.ops.aten.bmm.default
            and getattr(_state, "unbatched", False)):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return ckpt.create_selective_checkpoint_contexts(save_dots)


def wrap(fn: Callable, policy: str) -> Callable:
    """``fn`` checkpointed under ``policy`` (one of :data:`POLICIES`) when
    autograd records, and ``fn`` itself when it does not."""
    if policy not in POLICIES:
        raise ValueError(f"remat_policy {policy!r}: the port supports "
                         f"{' and '.join(map(repr, POLICIES))}")
    kwargs = {} if policy == "nothing" else {"context_fn": _dots_contexts}

    @functools.wraps(fn)
    def remat(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kwargs)

    return remat
