"""Run a function of plain tensors on the local shards of DTensors.

The port's kernels take raw pointers through ctypes, and its own
``autograd.Function``s compute on whole axes: on DTensors they run on each
rank's block (``to_local``) and their result goes back with the placements
the caller names (``DTensor.from_local``).  That is sound only while the
axes the function contracts are whole on every rank; :func:`on_local`
raises where one is split over a mesh dim of more than one rank, so that no
such call falls back to a different computation.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def split_dims(x) -> Tuple[int, ...]:
    """The tensor dims of DTensor ``x`` split over a mesh dim of more than
    one rank (a plain tensor has none)."""
    if not is_dtensor(x):
        return ()
    out = []
    for size, p in zip(x.device_mesh.shape, x.placements):
        if size > 1 and p.is_shard():
            out.append(p.dim % x.dim())
    return tuple(out)


def settled(x):
    """``x`` with its pending (partial) sums reduced: a function of the
    local block needs the values themselves."""
    if not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


class _DenseGrad(torch.autograd.Function):
    """Identity whose output and gradient are contiguous: the backward of
    a local product can hand DTensor a strided block, which its views of
    the block refuse."""

    @staticmethod
    def forward(ctx, x):
        return x.contiguous()

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _dense(t):
    return _DenseGrad.apply(t) if t.is_floating_point() else t


def on_local(fn: Callable, args: Sequence, whole: Sequence[Sequence[int]],
             name: str, layouts: Optional[Sequence] = None,
             grads: Optional[Sequence] = None, out=None):
    """``fn(*args)`` on the local blocks of the DTensor ``args`` (as is
    when none is a DTensor: the plain call is the one-rank case of the
    same body).

    The first DTensor argument leads: its mesh is the function's, and its
    layout (``layouts[i]`` where given, else its own) is the default of
    the other DTensor arguments of as many dims and of the result.
    ``layouts[i]`` names the placements ``args[i]`` is redistributed to (a
    plain tensor given one is whole on every rank, so it is taken as
    replicated first); ``grads[i]`` the placements of its gradient's block
    (``to_local``'s ``grad_placements``, e.g. a partial sum where each rank
    uses a replicated weight on its own rows); ``out`` the result's
    placements, one for all of a tuple's tensors or a list with one per
    tensor.  ``whole[i]`` lists the dims of ``args[i]`` that ``fn``
    contracts: each must be whole on every rank after the redistribution,
    or the call raises."""
    n = len(args)
    layouts = list(layouts) if layouts is not None else [None] * n
    grads = list(grads) if grads is not None else [None] * n
    args = [settled(a) if is_dtensor(a) else a for a in args]
    at = next((i for i, a in enumerate(args) if is_dtensor(a)), None)
    if at is None:
        return fn(*args)
    mesh = args[at].device_mesh
    lead = layouts[at] if layouts[at] is not None else args[at].placements
    lead, ndim = tuple(lead), args[at].dim()
    local = []
    for a, dims, want, grad in zip(args, whole, layouts, grads):
        if not isinstance(a, torch.Tensor) or (want is None
                                               and not is_dtensor(a)):
            local.append(a)
            continue
        if not is_dtensor(a):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if a.device_mesh != mesh:
            raise ValueError(f"{name}: operands on different meshes")
        if want is None and a.dim() == ndim:
            want = lead
        if want is not None and tuple(want) != tuple(a.placements):
            a = a.redistribute(mesh, want)
        bad = sorted(set(d % a.dim() for d in dims) & set(split_dims(a)))
        if bad:
            raise ValueError(
                f"{name}: dims {bad} of a {tuple(a.shape)} operand are split "
                f"over the mesh ({a.placements}); the function needs them "
                "whole on each rank")
        local.append(_dense(a.to_local(grad_placements=grad)))
    result = fn(*local)
    many = isinstance(result, tuple)
    outs = result if many else (result,)
    if out is None or not isinstance(out[0], (list, tuple)):
        out = [out if out is not None else lead] * len(outs)

    def wrap(t, placements):
        if not isinstance(t, torch.Tensor):
            return t
        return DTensor.from_local(_dense(t), mesh, placements,
                                  run_check=False)

    wrapped = tuple(wrap(t, p) for t, p in zip(outs, out))
    return wrapped if many else wrapped[0]


def replicated(x):
    """A DTensor made whole on every rank (its pending sums reduced, its
    shards gathered); a plain tensor as it is."""
    if not is_dtensor(x) or all(p.is_replicate() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def local_range(x, dim: int, placements=None) -> Tuple[int, int]:
    """(start, length) of this rank's block of DTensor ``x`` along ``dim``
    in the whole tensor, under ``placements`` (its own by default): the
    mesh dims that split ``dim`` index the blocks outer dim first (even
    blocks, as the sharding rules make them)."""
    mesh, dim = x.device_mesh, dim % x.dim()
    coord = mesh.get_coordinate()
    block, n = 0, 1
    for i, p in enumerate(placements or x.placements):
        if p.is_shard() and p.dim % x.dim() == dim:
            block = block * mesh.shape[i] + coord[i]
            n *= mesh.shape[i]
    length = x.shape[dim] // n
    return block * length, length
