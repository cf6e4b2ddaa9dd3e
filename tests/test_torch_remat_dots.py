"""The port's ``remat_policy="dots"`` against the JAX package's.

Under ``"dots"`` the reference checkpoints each layer with
``dots_with_no_batch_dims_saveable``: the outputs of its products without
batch dimensions are saved, everything else is recomputed in the backward
pass.  The port keeps the same set with selective checkpointing
(``models/remat.py``).  On six smoke configs (a dense, an MoE, a griffin
with two tail layers, an xLSTM, an encoder-decoder and the M-RoPE dense
one), both packages run on the same weights, carried over with
``params_from_jax``, and the same numpy batches:

  * the port's ``"dots"`` loss and per-leaf gradients against the
    reference's ``"dots"`` (1e-4 normwise in float32, as
    ``tests/test_torch_train.py``);
  * the port's ``"dots"`` against its own ``"nothing"``, bit for bit, in
    float32 and bfloat16;
  * the saved set: in each checkpointed block the number of products the
    policy keeps equals the number of ``dot_general`` equations with empty
    batch dimensions inside the reference's ``checkpoint`` equation of that
    stack (``jax.make_jaxpr``; with ``scan_layers`` each stack holds one
    block body), the MoE router and the M-RoPE angles included;
  * the backward reruns no product without batch dimensions, and reruns
    every batched product and every kernel's plain version as often as
    under ``"nothing"``;
  * any other policy raises.  The JAX side is jitted.
"""
import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint
from jax.extend import core as jcore
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro import models as jmodels
from repro_torch import _tree
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.kernels import ops
from repro_torch.models import layers as tlayers
from repro_torch.models import remat

ARCHS = ["llama3-8b", "qwen2-moe-a2.7b", "recurrentgemma-2b", "xlstm-125m",
         "whisper-small", "qwen2-vl-72b"]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
# the reference's no-batch-dims products per block body of the smoke
# configs: q, k, v, o and the three MLP projections (+ the router, + the
# two M-RoPE angle products); a griffin group is two recurrent sublayers
# (w_x, w_gate, w_a, w_i, w_out and the MLP's three) and an attention one
SAVED = {"llama3-8b": [7], "qwen2-moe-a2.7b": [8],
         "recurrentgemma-2b": [23, 8], "qwen2-vl-72b": [9]}
B, S = 2, 16
# the name of ``jax.checkpoint``'s primitive (``remat2`` in jax 0.9)
_CHECKPOINT = ("checkpoint", "remat2")
MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
BMM = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _normwise(got, want) -> float:
    g, w = _np(got), _np(want)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _configs(arch: str, dtype: str, policy: str = "dots"):
    jd, td, _ = DTYPES[dtype]
    kw = dict(remat=True, remat_policy=policy)
    if arch == "recurrentgemma-2b":
        kw["n_layers"] = 8  # two groups and two tail layers
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), dtype=jd,
                               param_dtype=jd, **kw)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch), dtype=td,
                               param_dtype=td, **kw)
    return jcfg, tcfg


def _params(jcfg, tcfg):
    jparams, _ = jmodels.init_model(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), jparams)
    return jparams, tmodels.params_from_jax(tree, tcfg, "cpu")


def _batch(cfg, seed=0):
    """Tokens and labels (five masked), with (3, B, S) M-RoPE positions
    whose streams differ for an M-RoPE config and stub frames for the
    encoder-decoder."""
    rng = np.random.default_rng(seed)
    np_batch = {"tokens": rng.integers(1, cfg.vocab, (B, S)),
                "labels": rng.integers(1, cfg.vocab, (B, S))}
    np_batch["labels"][0, :5] = -1
    if cfg.mrope_sections:
        i = np.arange(S)
        grid = np.maximum(i - 4, 0)
        t = np.where(i < 4, i, 4)
        np_batch["positions"] = np.broadcast_to(np.stack([
            t, np.where(i < 4, i, 4 + grid // 4),
            np.where(i < 4, i, 4 + grid % 4)])[:, None], (3, B, S)).copy()
    if cfg.family == "encdec":
        np_batch["frames"] = rng.standard_normal(
            (B, S // cfg.enc_frames_ratio, cfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v, jnp.float32 if k == "frames" else jnp.int32)
          for k, v in np_batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in np_batch.items()}
    return jb, tb


def _grads(tparams, tcfg, batch):
    xs = [p.detach().requires_grad_() for p in _tree.leaves(tparams)]
    loss, _ = tmodels.loss_fn(_tree.rebuild(tparams, xs), tcfg, batch)
    return loss, torch.autograd.grad(loss, xs)


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_matches_the_reference(arch):
    jcfg, tcfg = _configs(arch, "float32")
    jparams, tparams = _params(jcfg, tcfg)
    jb, tb = _batch(jcfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodels.loss_fn(p, jcfg, jb), has_aux=True))(jparams)
    tl, tg = _grads(tparams, tcfg, tb)
    tol = DTYPES["float32"][2]
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=tol, err_msg="loss")
    names = ["/".join(map(str, path)) for path, _ in
             jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert len(tg) == len(names)
    for name, got, want in zip(names, tg, jax.tree.leaves(jg)):
        err = _normwise(got, want)
        assert err <= tol, f"{name}: normwise {err}"
        assert float(got.norm()) > 0, name


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_dots_equals_nothing_bit_for_bit(arch, dtype):
    _, tcfg = _configs(arch, dtype)
    _, tparams = _params(*_configs(arch, dtype))
    _, tb = _batch(tcfg)
    want_l, want = _grads(tparams, dataclasses.replace(
        tcfg, remat_policy="nothing"), tb)
    got_l, got = _grads(tparams, tcfg, tb)
    assert torch.equal(got_l, want_l)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _subjaxprs(eqn):
    for v in eqn.params.values():
        for j in (v if isinstance(v, (list, tuple)) else [v]):
            if isinstance(j, jcore.ClosedJaxpr):
                yield j.jaxpr
            elif isinstance(j, jcore.Jaxpr):
                yield j


def _unbatched_dots(jaxpr) -> int:
    """``dot_general`` equations with empty batch dimensions in ``jaxpr``
    and the jaxprs nested in it (a scan's body once a step)."""
    n = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (_, _), (lhs_batch, rhs_batch) = eqn.params["dimension_numbers"]
            n += not lhs_batch and not rhs_batch
        mult = eqn.params.get("length", 1) if \
            eqn.primitive.name == "scan" else 1
        n += mult * sum(_unbatched_dots(j) for j in _subjaxprs(eqn))
    return n


def _reference_saved(jaxpr, mult: int = 1):
    """The no-batch-dims products of each ``checkpoint`` equation, once
    for each layer its enclosing scans run it, in program order."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in _CHECKPOINT:
            out += [_unbatched_dots(eqn.params["jaxpr"])] * mult
            continue
        inner = mult * (eqn.params.get("length", 1)
                        if eqn.primitive.name == "scan" else 1)
        for j in _subjaxprs(eqn):
            out += _reference_saved(j, inner)
    return out


def _port_saved(monkeypatch, tparams, tcfg, tb):
    """The products the policy keeps in each checkpointed block of one
    forward, in program order."""
    blocks = []
    real_policy, real_ckpt = remat.save_dots, torch.utils.checkpoint.checkpoint

    def policy(ctx, op, *args, **kwargs):
        decision = real_policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            blocks[-1] += decision == \
                torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
        return decision

    def checkpoint(*args, **kwargs):
        blocks.append(0)
        return real_ckpt(*args, **kwargs)

    monkeypatch.setattr(remat, "save_dots", policy)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", checkpoint)
    xs = [p.detach().requires_grad_() for p in _tree.leaves(tparams)]
    tmodels.loss_fn(_tree.rebuild(tparams, xs), tcfg, tb)
    return blocks


@pytest.mark.parametrize("arch", ARCHS)
def test_saved_set_matches_the_reference_jaxpr(monkeypatch, arch):
    jcfg, tcfg = _configs(arch, "float32")
    jparams, tparams = _params(jcfg, tcfg)
    jb, tb = _batch(jcfg)
    want = _reference_saved(jax.make_jaxpr(
        lambda p: jmodels.loss_fn(p, jcfg, jb))(jparams).jaxpr)
    got = _port_saved(monkeypatch, tparams, tcfg, tb)
    assert got == want
    if arch in SAVED:
        assert sorted(set(got), reverse=True) == SAVED[arch]


class _Count(TorchDispatchMode):
    """Counts products by kind, and whether they ran in a recompute."""

    def __init__(self, flags):
        super().__init__()
        self.n = Counter()
        self.flags = flags

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kind = ("mm" if func in MM else "bmm" if func in BMM else None)
        if kind is not None:
            if kind == "bmm" and getattr(remat._state, "unbatched", False):
                kind = "unbatched_bmm"
            self.n[kind] += 1
            if self.flags["recompute"]:
                self.n["recompute_" + kind] += 1
        return func(*args, **(kwargs or {}))


def _counted_step(monkeypatch, tparams, tcfg, tb):
    """One forward and backward: product counts of each pass, and the
    calls of ``ops.rg_lru`` and ``layers.chunked_attention`` (the kernels'
    plain versions on the CPU) in each."""
    flags = {"recompute": False, "backward": False}
    calls = Counter()
    real_ckpt = torch.utils.checkpoint.checkpoint

    def checkpoint(fn, *args, **kwargs):
        def marked(*a):
            flags["recompute"] = flags["backward"]
            try:
                return fn(*a)
            finally:
                flags["recompute"] = False
        return real_ckpt(marked, *args, **kwargs)

    def counted(name, real):
        def call(*args, **kwargs):
            calls[name, flags["backward"]] += 1
            return real(*args, **kwargs)
        return call

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", checkpoint)
    monkeypatch.setattr(ops, "rg_lru", counted("rg_lru", ops.rg_lru))
    monkeypatch.setattr(tlayers, "chunked_attention", counted(
        "attention", tlayers.chunked_attention))
    xs = [p.detach().requires_grad_() for p in _tree.leaves(tparams)]
    with _Count(flags) as fwd:
        loss, _ = tmodels.loss_fn(_tree.rebuild(tparams, xs), tcfg, tb)
    flags["backward"] = True
    with _Count(flags) as bwd:
        torch.autograd.grad(loss, xs)
    monkeypatch.undo()
    return fwd.n, bwd.n, calls


@pytest.mark.parametrize("arch", ARCHS)
def test_backward_reruns_no_unbatched_product(monkeypatch, arch):
    _, tcfg = _configs(arch, "float32")
    _, tparams = _params(*_configs(arch, "float32"))
    _, tb = _batch(tcfg)
    nf, nb, ncalls = _counted_step(monkeypatch, tparams, dataclasses.replace(
        tcfg, remat_policy="nothing"), tb)
    df, db, dcalls = _counted_step(monkeypatch, tparams, tcfg, tb)
    assert df == nf  # the forwards are the same
    assert nb["recompute_mm"] > 0
    assert db["recompute_mm"] == db["recompute_unbatched_bmm"] == 0
    for kind in ("mm", "unbatched_bmm"):
        assert db[kind] == nb[kind] - nb["recompute_" + kind], kind
    for kind in ("bmm", "recompute_bmm"):
        assert db[kind] == nb[kind], kind
    assert dcalls == ncalls
    if tcfg.mrope_sections or tcfg.n_experts:
        assert nb["recompute_unbatched_bmm"] > 0


@pytest.mark.parametrize("policy", ["everything", "dots_saveable", ""])
def test_other_policy_raises(policy):
    _, tcfg = _configs("llama3-8b", "float32", policy)
    _, tparams = _params(*_configs("llama3-8b", "float32"))
    _, tb = _batch(tcfg)
    with pytest.raises(ValueError, match="'nothing' and 'dots'"):
        tmodels.loss_fn(tparams, tcfg, tb)
