"""The port's moe family (Qwen1.5-MoE, Arctic) against the JAX package's.

Both packages run on the same weights: the JAX init's parameters, carried
over with ``params_from_jax``, and the same numpy token streams.  Each smoke
config runs in float32 (1e-4) and bfloat16 (2e-2), as
``tests/test_torch_dense.py`` holds the dense family: parameters, forward
logits and aux loss, ``loss_fn`` and per-leaf gradients, prefill, decode
and one ``build_train_step`` step.

Routing is discontinuous: a token whose k-th and (k+1)-th router
probabilities are nearly tied goes to another expert when its input moves
by one rounding.  By default XLA keeps fused chains of bf16 operations in
float32 (``xla_allow_excess_precision``) and rounds differently from an
op-by-op run, and on the Qwen smoke config (seed 0) one token of layer 1
has its 2nd and 3rd probabilities 4.8e-6 apart: so compiled, the reference
routes it elsewhere and the router's gradient differs by 0.2 normwise.
The bf16 reference is therefore compiled with that option off, rounding
every operation as an op-by-op run and the port do (router gradient 8e-3
apart).  ``test_moe_block_alone`` holds the routing itself, token by
token, wherever the tie is wider than 1e-6, and prints how many are not.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro import optim as joptim
from repro.models import moe as jmoe
from repro.runtime import steps as jsteps
from repro_torch import _tree
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch import optim as toptim
from repro_torch.models import moe as tmoe
from repro_torch.runtime import steps as tsteps
from test_torch_dense import DTYPES, _close, _normwise, _np, _tokens

ARCHS = ["qwen2_moe_a2_7b", "arctic_480b"]
IDS = {"qwen2_moe_a2_7b": "qwen2-moe-a2.7b", "arctic_480b": "arctic-480b"}
B = 2
N_DECODE = 3
TIE = 1e-6


def _jit(fn, dtype: str):
    """``fn`` compiled; in bfloat16 with XLA's excess precision off (module
    docstring)."""
    if dtype == "float32":
        return jax.jit(fn)

    def run(*args):
        return jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})(*args)

    return run


def _configs(arch: str, dtype: str):
    jd, td, _ = DTYPES[dtype]
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), dtype=jd,
                               param_dtype=jd)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch), dtype=td,
                               param_dtype=td)
    return jcfg, tcfg


def _pair(arch: str, dtype: str, seed: int = 0):
    jcfg, tcfg = _configs(arch, dtype)
    jparams, _ = jmodels.init_model(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), jparams)
    return jcfg, jparams, tcfg, tmodels.params_from_jax(tree, tcfg, "cpu")


@pytest.fixture(scope="module",
                params=[(a, d) for a in ARCHS for d in sorted(DTYPES)],
                ids=lambda p: f"{IDS[p[0]]}-{p[1]}")
def pair(request):
    arch, dtype = request.param
    return (arch, dtype, *_pair(arch, dtype))


def test_params_carried_over(pair):
    arch, dtype, jcfg, jparams, tcfg, tparams = pair
    assert tmodels.param_count(tparams) == jmodels.param_count(jparams)
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(jflat) == len(_tree.leaves(tparams))
    for path, leaf in jflat:
        node = tparams
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        want = torch.float32 if path[-1].key == "router" else \
            DTYPES[dtype][1]
        assert node.dtype == want, path
        np.testing.assert_array_equal(_np(node), _np(leaf))
    layer = tparams["layers"]
    assert ("mlp" in layer) == tcfg.dense_residual
    assert ("shared" in layer) == (tcfg.n_shared > 0)
    assert tuple(layer["moe"]["w_gate"].shape) == (
        2, tcfg.n_experts, 64, tcfg.moe_d_ff)


def test_init_model_router_is_float32():
    _, tcfg = _configs("qwen2_moe_a2_7b", "bfloat16")
    params = tmodels.init_model(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert params["layers"]["moe"]["router"].dtype == torch.float32
    assert params["layers"]["moe"]["w_up"].dtype == torch.bfloat16
    assert tuple(params["layers"]["shared"]["w_gate"].shape) == (
        2, 64, tcfg.n_shared * tcfg.moe_d_ff)


def test_forward_logits_and_aux(pair):
    arch, dtype, jcfg, jparams, tcfg, tparams = pair
    s = 12
    toks = _tokens(1, jcfg.vocab, B, s)
    want, jaux = _jit(lambda p, t: jmodels.forward(p, jcfg, t), dtype)(
        jparams, jnp.asarray(toks, jnp.int32))
    got, aux = tmodels.forward(tparams, tcfg, torch.as_tensor(toks))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, s, 512)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    tol = DTYPES[dtype][2]
    _close(got, want, tol, "forward logits")
    np.testing.assert_allclose(_np(aux), _np(jaux), rtol=tol, err_msg="aux")
    assert float(aux) > 0.0


def _batch(cfg, b=4, s=16, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab, (b, s))
    labels = rng.integers(1, cfg.vocab, (b, s))
    labels[0, :5] = -1  # masked
    jb = {"tokens": jnp.asarray(tokens, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32)}
    tb = {"tokens": torch.as_tensor(tokens), "labels": torch.as_tensor(labels)}
    return jb, tb


def test_loss_and_per_leaf_gradients(pair):
    arch, dtype, jcfg, jparams, tcfg, tparams = pair
    jb, tb = _batch(jcfg)
    (jl, jm), jg = _jit(jax.value_and_grad(
        lambda p: jmodels.loss_fn(p, jcfg, jb), has_aux=True), dtype)(jparams)
    xs = [p.detach().requires_grad_() for p in _tree.leaves(tparams)]
    tl, tm = tmodels.loss_fn(_tree.rebuild(tparams, xs), tcfg, tb)
    tg = torch.autograd.grad(tl, xs)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=tol, err_msg="loss")
    np.testing.assert_allclose(_np(tm["ce"]), _np(jm["ce"]), rtol=tol)
    np.testing.assert_allclose(_np(tm["aux"]), _np(jm["aux"]), rtol=tol)
    assert int(tm["tokens"]) == int(jm["tokens"]) == 4 * 16 - 5
    names = ["/".join(map(str, path)) for path, _ in
             jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert len(tg) == len(names)
    for name, got, want in zip(names, tg, jax.tree.leaves(jg)):
        want_dtype = torch.float32 if "router" in name else DTYPES[dtype][1]
        assert got.dtype == want_dtype, name
        err = _normwise(got, want)
        assert err <= tol, f"{name}: normwise {err}"
        assert float(got.float().norm()) > 0, name
    # every expert of every layer is trained (the smoke batch reaches all)
    for key in ("w_gate", "w_up", "w_down"):
        g = tg[names.index(f"['layers']/['moe']/['{key}']")]
        assert bool((g.float().flatten(2).norm(dim=-1) > 0).all()), key


def test_prefill_and_decode(pair):
    arch, dtype, jcfg, jparams, tcfg, tparams = pair
    tol = DTYPES[dtype][2]
    s = 12
    toks = _tokens(2, jcfg.vocab, B, s + N_DECODE)
    max_len = s + N_DECODE + 1
    jl, jc = _jit(lambda p, t: jmodels.prefill(p, jcfg, t, max_len=max_len),
                  dtype)(jparams, jnp.asarray(toks[:, :s], jnp.int32))
    tl, tc = tmodels.prefill(tparams, tcfg, torch.as_tensor(toks[:, :s]),
                             max_len=max_len)
    _close(tl, jl, tol, "prefill last logits")
    assert set(tc) == set(jc) == {"k", "v", "index"}
    assert tuple(tc["k"].shape) == tuple(jc["k"].shape)
    for key in sorted(jc):
        _close(tc[key], jc[key], tol, f"prefill cache {key}")
    jstep = _jit(lambda p, c, t: jmodels.decode_step(p, jcfg, c, t), dtype)
    for t in range(s, s + N_DECODE):
        step = toks[:, t:t + 1]
        jl, jc = jstep(jparams, jc, jnp.asarray(step, jnp.int32))
        tl, tc = tmodels.decode_step(tparams, tcfg, tc, torch.as_tensor(step))
        _close(tl, jl, tol, f"decode logits at {t}")
    for key in sorted(jc):
        _close(tc[key], jc[key], tol, f"decode cache {key}")
    assert int(tc["index"]) == int(jc["index"]) == s + N_DECODE


@pytest.mark.parametrize("arch", ARCHS, ids=IDS.get)
def test_prefill_then_decode_matches_forward(arch):
    """Teacher forcing (``tests/test_models.py``'s check): prefill's last
    logits and each decode step's equal the training forward's at the same
    position, in float32.  A decode step routes one token (capacity 8), so
    no token is dropped there."""
    _, _, tcfg, tparams = _pair(arch, "float32")
    s = 16
    toks = torch.as_tensor(_tokens(3, tcfg.vocab, B, s + N_DECODE))
    full, _ = tmodels.forward(tparams, tcfg, toks)
    logits, cache = tmodels.prefill(tparams, tcfg, toks[:, :s],
                                    max_len=s + 4)
    _close(logits[:, 0], full[:, s - 1], 2e-2, "prefill vs forward")
    for t in range(s, s + N_DECODE):
        logits, cache = tmodels.decode_step(tparams, tcfg, cache,
                                            toks[:, t:t + 1])
        _close(logits[:, 0], full[:, t], 2e-2, f"decode vs forward at {t}")


@pytest.mark.parametrize("arch", ARCHS, ids=IDS.get)
def test_train_step_matches_the_reference(arch):
    """One bf16 train step of each package from the same state and batch
    (2 micro-batches), held as the dense family's step is, the aux loss
    included; the reference's step is compiled without excess precision
    (module docstring)."""
    jcfg, tcfg = _configs(arch, "bfloat16")
    jopt = joptim.AdamWConfig(lr=1e-3, warmup_steps=0)
    topt = toptim.AdamWConfig(lr=1e-3, warmup_steps=0)
    jstate, _ = jsteps.init_train_state(jcfg, jopt, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jstate.params)
    tstate = tsteps.init_train_state(tcfg, topt, torch.Generator(), "cpu")
    tstate.params = tmodels.params_from_jax(tree, tcfg, "cpu")
    jb, tb = _batch(jcfg, b=4, s=16, seed=2)
    js, jm = _jit(jsteps.build_train_step(jcfg, jopt, n_micro=2),
                  "bfloat16")(jstate, jb)
    ts, tm = tsteps.build_train_step(tcfg, topt, n_micro=2)(tstate, tb)
    np.testing.assert_allclose(_np(tm["loss"]), _np(jm["loss"]), rtol=1e-4,
                               err_msg="loss")
    for k in ("grad_norm", "lr", "aux"):
        np.testing.assert_allclose(_np(tm[k]), _np(jm[k]), rtol=2e-2,
                                   atol=1e-7, err_msg=k)
    assert float(tm["aux"]) > 0.0
    assert int(ts.step) == int(js.step) == 1
    for a, b in zip(_tree.leaves(ts.params), jax.tree.leaves(js.params)):
        # Adam's sign-like first step in bf16 (tests/test_runtime.py)
        np.testing.assert_allclose(_np(a), _np(b), atol=2.6 * topt.lr)
    for m in _tree.leaves(ts.opt["m"]):
        assert float(m.norm()) > 0


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_block_alone(capacity_factor):
    """``moe_block`` on random float32 inputs (B=3, S=40 tokens a row, 8
    experts top-2; at capacity factor 0.5 many assignments drop): the same
    experts for every token whose 2nd and 3rd router probabilities are
    more than 1e-6 apart, then the same output and aux loss."""
    jcfg, tcfg = _configs("arctic_480b", "float32")
    jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
    tcfg = dataclasses.replace(tcfg, capacity_factor=capacity_factor)
    jparams, _ = jmoe.init_moe(jcfg, jax.random.PRNGKey(3))
    tparams = tmodels.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jparams), tcfg,
        "cpu")
    x = np.random.default_rng(4).standard_normal((3, 40, 64)).astype(
        np.float32)
    probs, _, idx = tmoe._route(tparams, tcfg, torch.as_tensor(x))
    jprobs = jax.nn.softmax(jnp.einsum("bsd,de->bse", jnp.asarray(x),
                                       jparams["router"]), axis=-1)
    _, jidx = jax.lax.top_k(jprobs, jcfg.top_k)
    srt = np.sort(_np(probs), axis=-1)[..., ::-1]
    wide = (srt[..., jcfg.top_k - 1] - srt[..., jcfg.top_k]) > TIE
    print(f"{int((~wide).sum())} of {wide.size} tokens within {TIE} of a "
          "tie")
    np.testing.assert_array_equal(idx.numpy()[wide], np.asarray(jidx)[wide])
    y, aux = tmoe.moe_block(tparams, tcfg, torch.as_tensor(x))
    jy, jaux = jmoe.moe_block(jparams, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(_np(aux), _np(jaux), rtol=1e-5)
    rows = wide.all(axis=1)  # a near tie moves later tokens of its row
    _close(y[torch.as_tensor(rows)], np.asarray(jy)[rows], 1e-4,
           "moe_block output")
    assert rows.sum() >= 1
    # assignments kept within capacity, as the reference counts them
    c = tmoe.moe_capacity(40, tcfg)
    flat = idx.reshape(3, -1)
    kept = sum(int(torch.clamp_max(torch.bincount(row, minlength=8),
                                   c).sum()) for row in flat)
    print(f"capacity {c}: {kept} of {flat.numel()} assignments kept")
    if capacity_factor < 1:
        assert kept < flat.numel()


def test_top_k_breaks_ties_as_jax():
    """``jax.lax.top_k`` takes tied values lower index first; the port's
    stable sort does too, whatever ``torch.topk`` would do."""
    rows = np.array([[0.25, 0.25, 0.25, 0.25],
                     [0.1, 0.3, 0.3, 0.3],
                     [0.4, 0.1, 0.4, 0.1],
                     [0.2, 0.2, 0.1, 0.5],
                     [0.0, 0.0, 0.0, 1.0]], dtype=np.float32)
    x = np.concatenate([rows, rows[:, ::-1]])
    for k in (1, 2, 3):
        vals, idx = tmoe._top_k(torch.as_tensor(x), k)
        jvals, jidx = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("s", [1, 40, 1000])
def test_moe_capacity_equals_the_reference(s):
    for arch in ARCHS:
        jcfg, tcfg = jconfigs.get_config(IDS[arch]), tconfigs.get_config(
            IDS[arch])
        assert tmoe.moe_capacity(s, tcfg) == jmoe.moe_capacity(s, jcfg)
    assert tmoe.moe_capacity(1, tcfg) == 8


@pytest.mark.parametrize("arch", ARCHS, ids=IDS.get)
def test_full_config_equals_the_reference(arch):
    jcfg = jconfigs.get_config(IDS[arch])
    tcfg = tconfigs.get_config(IDS[arch])
    for f in dataclasses.fields(jcfg):
        a, b = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name in ("dtype", "param_dtype", "logit_dtype"):
            assert jnp.dtype(a).name == str(b).removeprefix("torch."), f.name
        else:
            assert a == b, f.name
    js, ts = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    for f in dataclasses.fields(js):
        if f.name not in ("dtype", "param_dtype", "logit_dtype"):
            assert getattr(js, f.name) == getattr(ts, f.name), f.name
    for alias in (arch, IDS[arch], arch.replace("_", "-")):
        assert tconfigs.canonical(alias) == jconfigs.canonical(alias) == arch


def _shape_count(cfg, monkeypatch) -> int:
    """The port's ``init_model`` parameter count at ``cfg``, every random
    leaf made on the meta device (nothing allocated)."""
    from repro_torch.models import layers, moe, recurrent

    def meta(generator, shape, dtype, std):
        return torch.empty(shape, dtype=dtype, device="meta")

    for mod in (layers, moe, recurrent):
        monkeypatch.setattr(mod, "truncated_normal", meta)
    return tmodels.param_count(tmodels.init_model(cfg, torch.Generator(),
                                                  "meta"))


def _reference_count(arch: str) -> int:
    cfg = jconfigs.get_config(arch)
    shapes = jax.eval_shape(
        lambda k: jmodels.init_model(cfg, k)[0], jax.random.PRNGKey(0))
    return sum(math.prod(x.shape) for x in jax.tree.leaves(shapes))


@pytest.mark.parametrize("arch", ARCHS, ids=IDS.get)
def test_full_parameter_count_equals_the_reference(arch, monkeypatch):
    """Qwen1.5-MoE-A2.7B 14.32 B and Arctic 476.9 B parameters, counted
    from the shapes by both inits (JAX's under ``jax.eval_shape``)."""
    n = _shape_count(tconfigs.get_config(IDS[arch]), monkeypatch)
    assert n == _reference_count(IDS[arch])
    want = {"qwen2_moe_a2_7b": 14_315_587_584,
            "arctic_480b": 476_850_275_328}[arch]
    assert n == want
