"""The port's xlstm family (xLSTM-125M: alternating sLSTM / mLSTM blocks)
against the JAX package's.

Both packages run on the same weights: the JAX init's parameters, carried
over with ``params_from_jax``, and the same numpy token streams.  The smoke
config runs in float32 (1e-4) and bfloat16 (2e-2), as
``tests/test_torch_dense.py`` holds the dense family: parameters, forward
logits, ``loss_fn`` and per-leaf gradients, prefill, decode and one
``build_train_step`` step.  Sequences of 512 and 768 tokens span two and
three of the mLSTM's 256-token chunks, so the carried (C, n) state is
compared too.  The sLSTM's associative scan (``models/_assoc_scan.py``) is
held against ``jax.lax.associative_scan`` on its own.
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
from repro.models import recurrent as jrec
from repro.runtime import steps as jsteps
from repro_torch import _tree
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch import optim as toptim
from repro_torch.models import recurrent as trec
from repro_torch.models._assoc_scan import associative_scan
from repro_torch.runtime import steps as tsteps
from test_torch_dense import DTYPES, _close, _normwise, _np, _tokens
from test_torch_moe import _reference_count, _shape_count

ARCH = "xlstm_125m"
B = 2
N_DECODE = 3


def _configs(dtype: str):
    jd, td, _ = DTYPES[dtype]
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), dtype=jd,
                               param_dtype=jd)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype=td,
                               param_dtype=td)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=sorted(DTYPES))
def pair(request):
    dtype = request.param
    jcfg, tcfg = _configs(dtype)
    jparams, _ = jmodels.init_model(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), jparams)
    return (dtype, jcfg, jparams, tcfg,
            tmodels.params_from_jax(tree, tcfg, "cpu"))


def test_params_carried_over(pair):
    dtype, jcfg, jparams, tcfg, tparams = pair
    assert tmodels.param_count(tparams) == jmodels.param_count(jparams)
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(jflat) == len(_tree.leaves(tparams))
    for path, leaf in jflat:
        node = tparams
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert node.dtype == DTYPES[dtype][1], path
        np.testing.assert_array_equal(_np(node), _np(leaf))
    assert tuple(tparams["pairs"]["mlstm"]["w_i"].shape) == (2, 64, 2)


def test_init_model_shapes_and_scales():
    jcfg, tcfg = _configs("float32")
    jparams, _ = jmodels.init_model(jcfg, jax.random.PRNGKey(0))
    tparams = tmodels.init_model(tcfg, torch.Generator().manual_seed(0),
                                 "cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        node = tparams
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        std = float(np.std(np.asarray(leaf)))
        if leaf.size > 256 and std > 0:
            assert float(node.std()) == pytest.approx(std, rel=0.15), path


@pytest.mark.parametrize("s", [12, 512])
def test_forward_logits(pair, s):
    dtype, jcfg, jparams, tcfg, tparams = pair
    toks = _tokens(1, jcfg.vocab, B, s)
    want, jaux = jax.jit(lambda p, t: jmodels.forward(p, jcfg, t))(
        jparams, jnp.asarray(toks, jnp.int32))
    got, aux = tmodels.forward(tparams, tcfg, torch.as_tensor(toks))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, s, 512)
    assert float(aux) == float(jaux) == 0.0
    _close(got, want, DTYPES[dtype][2], "forward logits")


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
    dtype, jcfg, jparams, tcfg, tparams = pair
    jb, tb = _batch(jcfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodels.loss_fn(p, jcfg, jb), has_aux=True))(jparams)
    xs = [p.detach().requires_grad_() for p in _tree.leaves(tparams)]
    tl, tm = tmodels.loss_fn(_tree.rebuild(tparams, xs), tcfg, tb)
    tg = torch.autograd.grad(tl, xs)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=tol, err_msg="loss")
    np.testing.assert_allclose(_np(tm["ce"]), _np(jm["ce"]), rtol=tol)
    assert int(tm["tokens"]) == int(jm["tokens"]) == 4 * 16 - 5
    names = ["/".join(map(str, path)) for path, _ in
             jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert len(tg) == len(names)
    for name, got, want in zip(names, tg, jax.tree.leaves(jg)):
        assert got.dtype == DTYPES[dtype][1], name
        err = _normwise(got, want)
        assert err <= tol, f"{name}: normwise {err}"
        assert float(got.float().norm()) > 0, name


def test_prefill_and_decode(pair):
    dtype, jcfg, jparams, tcfg, tparams = pair
    tol = DTYPES[dtype][2]
    s = 12
    toks = _tokens(2, jcfg.vocab, B, s + N_DECODE)
    jl, jc = jax.jit(lambda p, t: jmodels.prefill(p, jcfg, t, max_len=16))(
        jparams, jnp.asarray(toks[:, :s], jnp.int32))
    tl, tc = tmodels.prefill(tparams, tcfg, torch.as_tensor(toks[:, :s]),
                             max_len=16)
    _close(tl, jl, tol, "prefill last logits")
    assert set(tc) == set(jc) == {"s_c", "s_n", "s_m", "m_C", "m_n", "m_m",
                                  "index"}
    for key in sorted(jc):
        assert tuple(tc[key].shape) == tuple(jc[key].shape), key
        _close(tc[key], jc[key], tol, f"prefill cache {key}")
    # the chunkwise form hands decode an unstabilized state: m = 0
    assert float(tc["m_m"].abs().max()) == 0.0
    jstep = jax.jit(lambda p, c, t: jmodels.decode_step(p, jcfg, c, t))
    for t in range(s, s + N_DECODE):
        step = toks[:, t:t + 1]
        jl, jc = jstep(jparams, jc, jnp.asarray(step, jnp.int32))
        tl, tc = tmodels.decode_step(tparams, tcfg, tc, torch.as_tensor(step))
        _close(tl, jl, tol, f"decode logits at {t}")
    for key in sorted(jc):
        _close(tc[key], jc[key], tol, f"decode cache {key}")
    assert int(tc["index"]) == int(jc["index"]) == s + N_DECODE


def test_init_cache_equals_the_reference():
    jcfg, tcfg = _configs("bfloat16")
    jc = jmodels.init_cache(jcfg, 3, 32)
    tc = tmodels.init_cache(tcfg, 3, 32, device="cpu")
    assert set(tc) == set(jc)
    for key in jc:
        assert tuple(tc[key].shape) == tuple(jc[key].shape), key
        assert str(tc[key].dtype).removeprefix("torch.") == \
            jnp.dtype(jc[key].dtype).name, key
        np.testing.assert_array_equal(_np(tc[key]), _np(jc[key]))
    assert float(tc["m_m"][0, 0, 0]) == -30.0
    assert float(tc["s_m"][0, 0, 0]) == float(np.float32(-1e30))


def test_decode_from_init_cache_matches_the_reference():
    """Decode from a fresh cache: the mLSTM's m = -30 stabilizer and the
    sLSTM's -1e30."""
    jcfg, tcfg = _configs("float32")
    jparams, _ = jmodels.init_model(jcfg, jax.random.PRNGKey(1))
    tparams = tmodels.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jparams), tcfg,
        "cpu")
    toks = _tokens(5, jcfg.vocab, B, 3)
    jc = jmodels.init_cache(jcfg, B, 8)
    tc = tmodels.init_cache(tcfg, B, 8, device="cpu")
    jstep = jax.jit(lambda p, c, t: jmodels.decode_step(p, jcfg, c, t))
    for t in range(3):
        jl, jc = jstep(jparams, jc, jnp.asarray(toks[:, t:t + 1], jnp.int32))
        tl, tc = tmodels.decode_step(tparams, tcfg, tc,
                                     torch.as_tensor(toks[:, t:t + 1]))
        _close(tl, jl, 1e-4, f"decode logits at {t}")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_prefill_then_decode_matches_forward(dtype):
    """Teacher forcing over three mLSTM chunks: prefill of 512 tokens (two
    chunks) and 3 decode steps against the training forward over 768 (the
    forward takes whole chunks only)."""
    jcfg, tcfg = _configs(dtype)
    jparams, _ = jmodels.init_model(jcfg, jax.random.PRNGKey(0))
    tparams = tmodels.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jparams), tcfg,
        "cpu")
    tol = DTYPES[dtype][2]
    s = 512
    toks = torch.as_tensor(_tokens(3, tcfg.vocab, B, 768))
    full, _ = tmodels.forward(tparams, tcfg, toks)
    logits, cache = tmodels.prefill(tparams, tcfg, toks[:, :s],
                                    max_len=s + N_DECODE)
    _close(logits[:, 0], full[:, s - 1], tol, "prefill vs forward")
    for t in range(s, s + N_DECODE):
        logits, cache = tmodels.decode_step(tparams, tcfg, cache,
                                            toks[:, t:t + 1])
        _close(logits[:, 0], full[:, t], tol, f"decode vs forward at {t}")


def test_mlstm_takes_whole_chunks():
    _, tcfg = _configs("float32")
    params = tmodels.init_model(tcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tmodels.forward(params, tcfg, torch.zeros((1, 300), dtype=torch.long))


def test_train_step_matches_the_reference():
    """One bf16 train step of each package from the same state and batch
    (2 micro-batches), held as the dense family's step is."""
    jcfg, tcfg = _configs("bfloat16")
    jopt = joptim.AdamWConfig(lr=1e-3, warmup_steps=0)
    topt = toptim.AdamWConfig(lr=1e-3, warmup_steps=0)
    jstate, _ = jsteps.init_train_state(jcfg, jopt, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jstate.params)
    tstate = tsteps.init_train_state(tcfg, topt, torch.Generator(), "cpu")
    tstate.params = tmodels.params_from_jax(tree, tcfg, "cpu")
    jb, tb = _batch(jcfg, b=4, s=16, seed=2)
    js, jm = jax.jit(jsteps.build_train_step(jcfg, jopt, n_micro=2))(jstate, jb)
    ts, tm = tsteps.build_train_step(tcfg, topt, n_micro=2)(tstate, tb)
    np.testing.assert_allclose(_np(tm["loss"]), _np(jm["loss"]), rtol=1e-4,
                               err_msg="loss")
    for k in ("grad_norm", "lr", "aux"):
        np.testing.assert_allclose(_np(tm[k]), _np(jm[k]), rtol=2e-2,
                                   atol=1e-7, err_msg=k)
    assert int(ts.step) == int(js.step) == 1
    for a, b in zip(_tree.leaves(ts.params), jax.tree.leaves(js.params)):
        np.testing.assert_allclose(_np(a), _np(b), atol=2.6 * topt.lr)
    for m in _tree.leaves(ts.opt["m"]):
        assert float(m.norm()) > 0


def _jax_combine(c1, c2):
    f1, m1, cc1, nn1 = c1
    f2, m2, cc2, nn2 = c2
    m = jnp.maximum(m1 + f2, m2)
    scale1 = jnp.exp(m1 + f2 - m)
    scale2 = jnp.exp(m2 - m)
    return f1 + f2, m, cc1 * scale1 + cc2 * scale2, nn1 * scale1 + nn2 * scale2


@pytest.mark.parametrize("s", [1, 2, 3, 7, 64, 100, 257, 1000])
def test_associative_scan_matches_jax(s):
    """The helper against ``jax.lax.associative_scan`` on random float32
    inputs along axis 1: a sum (the same adds in the same pairs, so equal
    to rounding), and the sLSTM's max-stabilised combine."""
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 3)).astype(np.float32)
    got = associative_scan(lambda a, b: [a[0] + b[0]], [torch.as_tensor(x)],
                           axis=1)[0]
    want = jax.lax.associative_scan(jnp.add, jnp.asarray(x), axis=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    elems = [-np.abs(x)] + [rng.standard_normal((2, s, 3)).astype(np.float32)
                            for _ in range(3)]
    got = associative_scan(trec._slstm_combine,
                           [torch.as_tensor(e) for e in elems], axis=1)
    want = jax.jit(lambda e: jax.lax.associative_scan(
        _jax_combine, tuple(e), axis=1))(elems)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_slstm_scan_with_state_matches_the_reference():
    """``slstm_scan`` over 33 steps from a carried (c, n, m) state."""
    jcfg, tcfg = _configs("float32")
    jp, _ = jrec.init_slstm(jcfg, jax.random.PRNGKey(2))
    tp = tmodels.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp), tcfg, "cpu")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 33, 64)).astype(np.float32)
    st = {"c": rng.standard_normal((2, 64)).astype(np.float32),
          "n": rng.uniform(0.5, 2.0, (2, 64)).astype(np.float32),
          "m": rng.standard_normal((2, 64)).astype(np.float32)}
    jy, js = jrec.slstm_scan(jp, jnp.asarray(x),
                             {k: jnp.asarray(v) for k, v in st.items()})
    ty, ts = trec.slstm_scan(tp, torch.as_tensor(x),
                             {k: torch.as_tensor(v) for k, v in st.items()})
    _close(ty, jy, 1e-4, "slstm y")
    for k in st:
        _close(ts[k], js[k], 1e-4, f"slstm state {k}")


def test_full_config_equals_the_reference():
    jcfg = jconfigs.get_config("xlstm-125m")
    tcfg = tconfigs.get_config("xlstm-125m")
    for f in dataclasses.fields(jcfg):
        a, b = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name in ("dtype", "param_dtype", "logit_dtype"):
            assert jnp.dtype(a).name == str(b).removeprefix("torch."), f.name
        else:
            assert a == b, f.name
    js, ts = jconfigs.get_smoke_config(ARCH), tconfigs.get_smoke_config(ARCH)
    for f in dataclasses.fields(js):
        if f.name not in ("dtype", "param_dtype", "logit_dtype"):
            assert getattr(js, f.name) == getattr(ts, f.name), f.name
    assert tcfg.pattern() == jcfg.pattern()
    assert tcfg.sub_quadratic and jcfg.sub_quadratic
    for alias in (ARCH, "xlstm-125m"):
        assert tconfigs.canonical(alias) == jconfigs.canonical(alias) == ARCH


def test_full_parameter_count_equals_the_reference(monkeypatch):
    n = _shape_count(tconfigs.get_config("xlstm-125m"), monkeypatch)
    assert n == _reference_count("xlstm-125m") == 109_164_288
    assert math.isclose(n / 1e6, 109.2, abs_tol=0.05)
