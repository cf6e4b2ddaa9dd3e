"""An inclusive associative scan, the JAX package's ``jax.lax.associative_scan``
step for step.

Torch has no public associative scan.  This one follows JAX's odd/even
recursion (Blelloch 1990): combine adjacent pairs, scan the half-length
result, combine each of its elements with the next even element of the
input, and interleave.  The combines happen in the same pairs and order as
in JAX, so a float32 combine rounds as it does there.  Each level is a few
elementwise launches over the whole sequence, log2(S) levels deep, and is
differentiable.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch

Elems = List[torch.Tensor]


def _slice(x: torch.Tensor, axis: int, start, stop, step: int = 1
           ) -> torch.Tensor:
    return x[(slice(None),) * axis + (slice(start, stop, step),)]


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
    """a at the even places along ``axis``, b at the odd ones; a is as long
    as b or one longer."""
    nb = b.shape[axis]
    pairs = torch.stack([_slice(a, axis, 0, nb), b], dim=axis + 1)
    out = pairs.flatten(axis, axis + 1)
    if a.shape[axis] > nb:
        out = torch.cat([out, _slice(a, axis, nb, None)], dim=axis)
    return out


def associative_scan(fn: Callable[[Sequence[torch.Tensor],
                                   Sequence[torch.Tensor]], Sequence],
                     elems: Sequence[torch.Tensor], axis: int = 0) -> Elems:
    """The inclusive scan of ``elems`` (a sequence of tensors of one length
    along ``axis``) under the associative ``fn(a, b)``, which takes and
    returns sequences of tensors in ``elems``' order."""
    elems = list(elems)
    axis = axis % elems[0].dim()

    def combine(a: Elems, b: Elems) -> Elems:
        return list(fn(a, b))

    def scan(elems: Elems) -> Elems:
        n = elems[0].shape[axis]
        if n < 2:
            return elems
        reduced = combine([_slice(e, axis, 0, -1, 2) for e in elems],
                          [_slice(e, axis, 1, None, 2) for e in elems])
        odd = scan(reduced)
        if n % 2 == 0:
            even = combine([_slice(e, axis, 0, -1) for e in odd],
                           [_slice(e, axis, 2, None, 2) for e in elems])
        else:
            even = combine(odd, [_slice(e, axis, 2, None, 2) for e in elems])
        even = [torch.cat([_slice(e, axis, 0, 1), r], dim=axis)
                for e, r in zip(elems, even)]
        return [_interleave(e, o, axis) for e, o in zip(even, odd)]

    return scan(elems)
