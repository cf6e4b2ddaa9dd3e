"""Logical-axis sharding rules with divisibility-aware axis selection, on
``torch.distributed`` ``DeviceMesh`` / DTensor (the JAX package's
``sharding/rules.py``).

The model code annotates tensors with *logical* axes ("batch", "heads",
"mlp", ...).  Each logical axis resolves to the first mesh axis (or axis
tuple) from its candidate list that (a) is not already used in this spec and
(b) divides the dimension size.  One model definition then shards across
every architecture, awkward head counts included (qwen3: 40 heads on tp=16
fall back to sequence sharding; whisper's 51865 vocab stays replicated).

Mesh axes (``launch/mesh.py``):
  pod   -- pure data parallelism across pods
  data  -- within-pod data parallel + FSDP weight sharding (ZeRO-3-like)
  model -- tensor parallelism (heads / mlp / vocab / expert-ffn)

A spec resolves to DTensor placements by :func:`placements`: a tensor dim
sharded over an axis tuple such as ``("pod", "data")`` is ``Shard(dim)`` on
each of those mesh dims, and DTensor splits it outer mesh dim first, which
is JAX's major-to-minor order.  :func:`logical_shard` redistributes a
DTensor to its spec; a plain tensor is not distributed and passes through,
so a model whose parameters are plain tensors runs unsharded under any
rules.  :func:`use_rules` with a ``DeviceMesh`` also lets plain tensors
(tokens, masks, positions drawn alike on every rank) mix with DTensors as
replicated ones (DTensor's implicit replication).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

AxisChoice = Union[None, str, Tuple[str, ...]]
Candidates = Sequence[AxisChoice]

# default logical rules: logical axis -> ordered candidate mesh axes
DEFAULT_RULES: Dict[str, Candidates] = {
    # activations
    "batch": [("pod", "data"), "data", None],
    "seq": [None],
    "seq_sharded": ["model", None],        # sequence parallelism fallback
    "embed": [None],
    "heads": ["model", None],
    "kv_heads": ["model", None],
    "kv_seq": ["model", None],             # flash-decoding style cache shard
    "mlp_act": ["model", None],
    "vocab_act": ["model", None],
    "experts_act": ["data", "model", None],
    # weights (FSDP on 'data', TP on 'model')
    "w_embed": ["data", None],
    "w_heads": ["model", None],
    "w_mlp": ["model", None],
    "w_vocab": ["model", None],
    "w_experts": [("pod", "data"), "data", None],
    "w_state": ["model", None],
    "w_replicated": [None],
    "opt_state": [("data", "model"), "data", None],
}


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name, or
    a tuple of mesh axis names (the counterpart of
    ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *parts: AxisChoice) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class AbstractMesh:
    """A mesh's axis names and sizes without devices or a process group
    (the counterpart of ``jax.sharding.AbstractMesh``): specs resolve
    against it, nothing can be placed on it."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh for the sharding rules needs "
                         "mesh_dim_names")
    return {a: int(n) for a, n in zip(names, mesh.shape)}


class AxisRules:
    def __init__(self, mesh, rules: Optional[Dict[str, Candidates]] = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)
        self.shape = mesh_shape(mesh) if mesh is not None else {}

    def axis_size(self, choice: AxisChoice) -> int:
        if choice is None or self.mesh is None:
            return 1
        names = (choice,) if isinstance(choice, str) else choice
        n = 1
        for a in names:
            if a not in self.shape:
                return 0  # axis not present in this mesh -> unusable
            n *= self.shape[a]
        return n


_ctx = threading.local()
_implicit_lock = threading.Lock()
_implicit = {"users": 0, "before": False, "per_thread": None}


def current_rules() -> Optional[AxisRules]:
    return getattr(_ctx, "rules", None)


def _flag_per_thread(disp) -> bool:
    """Whether DTensor keeps its implicit-replication flag per thread
    (newer torch) or once for the process (older torch): probed once, by
    flipping it here and reading it from another thread."""
    if _implicit["per_thread"] is None:
        before = disp._allow_implicit_replication
        seen = {}
        disp._allow_implicit_replication = not before
        probe = threading.Thread(target=lambda: seen.update(
            v=disp._allow_implicit_replication))
        probe.start()
        probe.join()
        disp._allow_implicit_replication = before
        _implicit["per_thread"] = seen["v"] == before
    return _implicit["per_thread"]


def _enter_implicit_replication() -> Optional[bool]:
    """Set DTensor's implicit-replication flag for a ``use_rules`` entered
    here.  Where the flag is per thread, this thread's value before it is
    returned for :func:`_leave_implicit_replication`.  Where it is one for
    the process, the users are counted: the flag stays set while any
    thread is inside, and goes back to its value before the first."""
    disp = DTensor._op_dispatcher
    with _implicit_lock:
        if _flag_per_thread(disp):
            prev = disp._allow_implicit_replication
            disp._allow_implicit_replication = True
            return prev
        if _implicit["users"] == 0:
            _implicit["before"] = disp._allow_implicit_replication
            disp._allow_implicit_replication = True
        _implicit["users"] += 1
        return None


def _leave_implicit_replication(prev: Optional[bool]) -> None:
    disp = DTensor._op_dispatcher
    with _implicit_lock:
        if _implicit["per_thread"]:
            disp._allow_implicit_replication = prev
            return
        _implicit["users"] -= 1
        if _implicit["users"] == 0:
            disp._allow_implicit_replication = _implicit["before"]


@contextlib.contextmanager
def use_rules(mesh, rules: Optional[Dict[str, Candidates]] = None):
    """Resolve logical axes against ``mesh`` in this thread (nestable; the
    outer rules come back on exit).  ``mesh`` is a ``DeviceMesh``, an
    :class:`AbstractMesh` or None (no rules).  Under a ``DeviceMesh``,
    plain tensors (tokens, masks) mix with DTensors as replicated ones
    (DTensor's implicit replication, held as
    :func:`_enter_implicit_replication` says)."""
    prev = getattr(_ctx, "rules", None)
    _ctx.rules = AxisRules(mesh, rules) if mesh is not None else None
    device_mesh = mesh is not None and not isinstance(mesh, AbstractMesh)
    implicit = _enter_implicit_replication() if device_mesh else None
    try:
        yield _ctx.rules
    finally:
        _ctx.rules = prev
        if device_mesh:
            _leave_implicit_replication(implicit)


def best_spec(shape: Sequence[int], logical: Sequence[Optional[str]],
              rules: Optional[AxisRules] = None) -> PartitionSpec:
    """Resolve logical axes -> PartitionSpec with divisibility checks."""
    rules = rules or current_rules()
    if rules is None or rules.mesh is None:
        return PartitionSpec()
    used: set = set()
    parts: List[AxisChoice] = []
    for dim, name in zip(shape, logical):
        chosen: AxisChoice = None
        if name is not None:
            for cand in rules.rules.get(name, [None]):
                if cand is None:
                    break
                names = (cand,) if isinstance(cand, str) else tuple(cand)
                size = rules.axis_size(cand)
                if size <= 0 or any(a in used for a in names):
                    continue
                if dim % size == 0:
                    chosen = cand
                    used.update(names)
                    break
        parts.append(chosen)
    return PartitionSpec(*parts)


def placements(spec: Sequence[AxisChoice], mesh) -> Tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on each
    mesh dim of more than one rank that shards tensor dim ``dim``,
    ``Replicate()`` elsewhere (on one rank the two are the same layout, and
    DTensor will not reshape a dim sharded there when its size is 1).  An
    axis tuple must list its mesh axes in the mesh's order (outer first),
    the only order DTensor's ``Shard`` expresses."""
    sizes = mesh_shape(mesh)
    names = list(sizes)
    out: List = [Replicate() for _ in names]
    for dim, part in enumerate(spec):
        if part is None:
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axis tuple {axes} is not in the mesh's order "
                             f"{tuple(names)}")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def logical_shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor to its logical axes' spec; no-op outside
    use_rules(), with no mesh, or for a plain (undistributed) tensor."""
    rules = current_rules()
    if rules is None or rules.mesh is None or isinstance(rules.mesh,
                                                         AbstractMesh):
        return x
    if not isinstance(x, DTensor):
        return x
    if any(p.is_partial() for p in x.placements):
        x = _Reduce.apply(x, rules.mesh, tuple(
            Replicate() if p.is_partial() else p for p in x.placements))
    spec = best_spec(x.shape, logical, rules)
    want = placements(spec, rules.mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(rules.mesh, want)


class _Reduce(torch.autograd.Function):
    """A DTensor's pending sums reduced (an all-reduce), and in the
    backward its gradient's pending sums too, the forward's all-reduce and
    its conjugate (tensor parallelism's pair): the reduced value is whole
    on every rank and so is its gradient.  DTensor's own redistribution
    hands the gradient back as a pending sum, and its products then reduce
    it by a reduce-scatter of an activation-sized (batch x sequence x mlp
    width) tensor in every layer's backward."""

    @staticmethod
    def forward(ctx, x, mesh, want):
        return x.redistribute(mesh, want)

    @staticmethod
    def backward(ctx, g):
        if any(p.is_partial() for p in g.placements):
            g = g.redistribute(g.device_mesh, [
                Replicate() if p.is_partial() else p for p in g.placements])
        return g, None, None


def param_spec(shape: Sequence[int], logical: Sequence[Optional[str]],
               rules: Optional[AxisRules] = None) -> PartitionSpec:
    """Spec for a parameter (how it is distributed before a step)."""
    return best_spec(shape, logical, rules)


def named_sharding(spec: PartitionSpec, rules: Optional[AxisRules] = None):
    """``(mesh, placements)`` of ``spec`` under the rules (the counterpart
    of a ``NamedSharding``), or None without a mesh."""
    rules = rules or current_rules()
    if rules is None or rules.mesh is None:
        return None
    return rules.mesh, placements(spec, rules.mesh)


def distribute(x: torch.Tensor, spec: Sequence[AxisChoice], mesh
               ) -> torch.Tensor:
    """A DTensor of ``x`` laid out by ``spec`` on ``mesh``.  ``x`` is the
    whole tensor, alike on every rank (drawn from one seed); each rank keeps
    its block, so nothing is sent.  The DTensor holds a copy: updating it
    in place leaves ``x`` as it was."""
    rep = DTensor.from_local(x.detach().clone(), mesh,
                             [Replicate()] * mesh.ndim, run_check=False)
    want = placements(spec, mesh)
    return rep if all(p == Replicate() for p in want) else \
        rep.redistribute(mesh, want)


def spec_leaves(spec_tree) -> List[Tuple]:
    """The logical-axis tuples of a spec tree (nested dicts whose leaves
    are tuples), in the parameters' leaf order (sorted keys)."""
    if isinstance(spec_tree, dict):
        return [x for k in sorted(spec_tree)
                for x in spec_leaves(spec_tree[k])]
    return [tuple(spec_tree)]


def shard_tree(tree, spec_tree, rules: Optional[AxisRules] = None):
    """Each tensor of ``tree`` distributed by its logical axes in
    ``spec_tree`` (same structure) under ``rules`` (default: the current
    ones), which must hold a ``DeviceMesh``."""
    rules = rules or current_rules()
    if rules is None or rules.mesh is None or isinstance(rules.mesh,
                                                         AbstractMesh):
        raise ValueError("shard_tree needs rules over a DeviceMesh")
    if isinstance(tree, dict):
        return {k: shard_tree(v, spec_tree[k], rules) for k, v in tree.items()}
    return distribute(tree, best_spec(tree.shape, spec_tree, rules),
                      rules.mesh)


def gather_fsdp(tree, spec_tree, rules: Optional[AxisRules] = None):
    """``tree``'s DTensor leaves made whole over their FSDP axes: each
    leaf's "w_embed" dim is gathered (ZeRO-3's per-layer weight gather;
    the gradient comes back reduce-scattered to the sharded layout), its
    other dims keep their tensor-parallel split.  The model calls it on a
    layer's parameters inside the layer's (rematerialised) body, so a
    layer's gathered weights live only while it runs; without it DTensor
    may gather the batch-sharded activations instead."""
    rules = rules or current_rules()
    if rules is None or rules.mesh is None or isinstance(rules.mesh,
                                                         AbstractMesh):
        return tree
    if isinstance(tree, dict):
        return {k: gather_fsdp(v, spec_tree[k], rules)
                for k, v in tree.items()}
    if not isinstance(tree, DTensor):
        return tree
    spec = best_spec(tree.shape, [None if a == "w_embed" else a
                                  for a in spec_tree], rules)
    want = placements(spec, rules.mesh)
    return tree if tuple(tree.placements) == want else tree.redistribute(
        rules.mesh, want)
