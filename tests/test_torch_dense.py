"""The port's dense family (Llama-3, Qwen3, InternLM2, StarCoder2, the
Qwen2-VL backbone) against the JAX package's.

Both packages run on the same weights: the JAX init's parameters, carried
over with ``params_from_jax``, and the same numpy token streams.  Each of
the five smoke configs runs in float32 (1e-4) and bfloat16 (2e-2, the bf16
tolerance of ``tests/test_models.py``).  Qwen2-VL gets explicit (3, B, S)
M-RoPE positions whose three streams differ (a 4-wide patch grid after a
text prefix), so every rotary section is exercised.  Gradients are held
per leaf, normwise; one ``build_train_step`` step is held as the griffin
step is in ``tests/test_torch_train.py``.  The JAX side is jitted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro import optim as joptim
from repro.runtime import steps as jsteps
from repro_torch import _tree
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch import optim as toptim
from repro_torch.runtime import steps as tsteps

ARCHS = ["llama3_8b", "qwen3_14b", "internlm2_20b", "starcoder2_15b",
         "qwen2_vl_72b"]
IDS = {"llama3_8b": "llama3-8b", "qwen3_14b": "qwen3-14b",
       "internlm2_20b": "internlm2-20b", "starcoder2_15b": "starcoder2-15b",
       "qwen2_vl_72b": "qwen2-vl-72b"}
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
B = 2
N_DECODE = 3


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, what):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol,
                               err_msg=what)


def _normwise(got, want) -> float:
    g, w = _np(got), _np(want)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


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


def _tokens(seed, vocab, b, s):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _positions(cfg, b, s):
    """(3, B, S) M-RoPE position streams for an M-RoPE config, else None:
    four text tokens, then a patch grid 4 wide (temporal, row, column)."""
    if not cfg.mrope_sections:
        return None
    i = np.arange(s)
    grid = np.maximum(i - 4, 0)
    t = np.where(i < 4, i, 4)
    h = np.where(i < 4, i, 4 + grid // 4)
    w = np.where(i < 4, i, 4 + grid % 4)
    return np.broadcast_to(np.stack([t, h, w])[:, None], (3, b, s)).copy()


def _inputs(pos):
    if pos is None:
        return None, None
    return jnp.asarray(pos, jnp.int32), torch.as_tensor(pos)


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
        assert node.dtype == DTYPES[dtype][1], path
        np.testing.assert_array_equal(_np(node), _np(leaf))
    attn = tparams["layers"]["attn"]
    assert ("q_norm" in attn and "k_norm" in attn) == tcfg.qk_norm
    assert tuple(attn["wk"].shape) == (2, 64, 2 * 16)


def test_forward_logits(pair):
    arch, dtype, jcfg, jparams, tcfg, tparams = pair
    s = 12
    toks = _tokens(1, jcfg.vocab, B, s)
    jpos, tpos = _inputs(_positions(jcfg, B, s))
    want, _ = jax.jit(lambda p, t, q: jmodels.forward(p, jcfg, t, positions=q)
                      )(jparams, jnp.asarray(toks, jnp.int32), jpos)
    got, aux = tmodels.forward(tparams, tcfg, torch.as_tensor(toks),
                               positions=tpos)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, s, 512)
    assert aux.dtype == torch.float32 and aux.dim() == 0 and float(aux) == 0.0
    _close(got, want, DTYPES[dtype][2], "forward logits")


def _batch(cfg, b=4, s=16, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab, (b, s))
    labels = rng.integers(1, cfg.vocab, (b, s))
    labels[0, :5] = -1  # masked
    jb = {"tokens": jnp.asarray(tokens, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32)}
    tb = {"tokens": torch.as_tensor(tokens), "labels": torch.as_tensor(labels)}
    pos = _positions(cfg, b, s)
    if pos is not None:
        jb["positions"], tb["positions"] = _inputs(pos)
    return jb, tb


def test_loss_and_per_leaf_gradients(pair):
    arch, dtype, jcfg, jparams, tcfg, tparams = pair
    jb, tb = _batch(jcfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodels.loss_fn(p, jcfg, jb), has_aux=True))(jparams)
    xs = [p.detach().requires_grad_() for p in _tree.leaves(tparams)]
    tl, tm = tmodels.loss_fn(_tree.rebuild(tparams, xs), tcfg, tb)
    tg = torch.autograd.grad(tl, xs)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=tol, err_msg="loss")
    np.testing.assert_allclose(_np(tm["ce"]), _np(jm["ce"]), rtol=tol)
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
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
    arch, dtype, jcfg, jparams, tcfg, tparams = pair
    tol = DTYPES[dtype][2]
    s = 12
    toks = _tokens(2, jcfg.vocab, B, s + N_DECODE)
    max_len = s + N_DECODE + 1
    jpos, tpos = _inputs(_positions(jcfg, B, s))
    jl, jc = jax.jit(lambda p, t, q: jmodels.prefill(
        p, jcfg, t, positions=q, max_len=max_len))(
            jparams, jnp.asarray(toks[:, :s], jnp.int32), jpos)
    tl, tc = tmodels.prefill(tparams, tcfg, torch.as_tensor(toks[:, :s]),
                             positions=tpos, max_len=max_len)
    _close(tl, jl, tol, "prefill last logits")
    assert set(tc) == set(jc) == {"k", "v", "index"}
    assert tuple(tc["k"].shape) == (2, B, max_len, 2, 16)
    assert tc["k"].dtype == DTYPES[dtype][1]
    for key in sorted(jc):
        _close(tc[key], jc[key], tol, f"prefill cache {key}")
    jstep = jax.jit(lambda p, c, t: jmodels.decode_step(p, jcfg, c, t))
    for t in range(s, s + N_DECODE):
        step = toks[:, t:t + 1]
        jl, jc = jstep(jparams, jc, jnp.asarray(step, jnp.int32))
        tl, tc = tmodels.decode_step(tparams, tcfg, tc, torch.as_tensor(step))
        _close(tl, jl, tol, f"decode logits at {t}")
    for key in sorted(jc):
        _close(tc[key], jc[key], tol, f"decode cache {key}")
    assert int(tc["index"]) == int(jc["index"]) == s + N_DECODE


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_prefill_then_decode_matches_forward(dtype):
    """Teacher forcing (``tests/test_models.py``'s check, for llama3_8b):
    prefill's last logits and each decode step's equal the training
    forward's at the same position."""
    _, _, tcfg, tparams = _pair("llama3_8b", dtype)
    tol = DTYPES[dtype][2]
    s = 16
    toks = torch.as_tensor(_tokens(3, tcfg.vocab, B, s + N_DECODE))
    full, _ = tmodels.forward(tparams, tcfg, toks)
    logits, cache = tmodels.prefill(tparams, tcfg, toks[:, :s],
                                    max_len=s + 4)
    _close(logits[:, 0], full[:, s - 1], tol, "prefill vs forward")
    for t in range(s, s + N_DECODE):
        logits, cache = tmodels.decode_step(tparams, tcfg, cache,
                                            toks[:, t:t + 1])
        _close(logits[:, 0], full[:, t], tol, f"decode vs forward at {t}")


@pytest.mark.parametrize("arch", ARCHS, ids=IDS.get)
def test_train_step_matches_the_reference(arch):
    """One bf16 train step of each package from the same state and batch
    (2 micro-batches), held as ``tests/test_torch_train.py`` holds the
    griffin step, but the loss at the float32 bar, 1e-4 relative: qk-norm
    adds two bf16 roundings a layer, and the mean over 59 tokens of
    float32 cross entropies from bf16 activations lands 1.4e-5 apart."""
    jcfg, tcfg = _configs(arch, "bfloat16")
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
        # Adam's sign-like first step in bf16: the reference's bound of ~2
        # x lr plus a bf16 rounding (tests/test_runtime.py)
        np.testing.assert_allclose(_np(a), _np(b), atol=2.6 * topt.lr)
    for m in _tree.leaves(ts.opt["m"]):
        assert float(m.norm()) > 0


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
    assert tcfg.pattern() == jcfg.pattern()
    for alias in (arch, IDS[arch], arch.replace("_", "-")):
        assert tconfigs.canonical(alias) == jconfigs.canonical(alias) == arch


def test_llama3_8b_full_width_parameter_count():
    """8.03 B parameters at full width and depth (arXiv:2407.21783), from
    the shapes alone (no allocation)."""
    cfg = tconfigs.get_config("llama3-8b")
    hd = cfg.head_dim
    per_layer = (2 * cfg.d_model
                 + cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv) * hd
                 + cfg.n_heads * hd * cfg.d_model
                 + 3 * cfg.d_model * cfg.d_ff)
    total = cfg.n_layers * per_layer + 2 * cfg.vocab * cfg.d_model \
        + cfg.d_model
    assert total == 8_030_261_248
    small = dataclasses.replace(cfg, n_layers=1, vocab=8, d_model=64,
                                n_heads=4, n_kv=2, d_ff=32)
    params = tmodels.init_model(small, torch.Generator(), "cpu")
    assert tmodels.param_count(params) == (
        2 * 64 + 64 * 8 * 16 + 4 * 16 * 64 + 3 * 64 * 32 + 2 * 8 * 64 + 64)


@pytest.mark.parametrize("entry", ["serve", "train"])
def test_entry_points_default_to_llama3_8b(entry, monkeypatch, capsys):
    """``python -m repro_torch.launch.{serve,train}`` with no ``--arch``
    runs llama3-8b's smoke config, as the reference's entry points do."""
    from repro_torch.launch import serve, train
    asked = []
    real = tconfigs.get_smoke_config

    def recorded(arch):
        asked.append(arch)
        return real(arch)

    monkeypatch.setattr(tconfigs, "get_smoke_config", recorded)
    if entry == "serve":
        serve.main(["--device", "cpu", "--requests", "2", "--batch", "2",
                    "--prompt-len", "4", "--gen", "2"])
        assert "served 2 requests, 4 tokens" in capsys.readouterr().out
    else:
        train.main(["--device", "cpu", "--steps", "1", "--batch", "2",
                    "--seq", "16"])
        assert capsys.readouterr().out.splitlines()[-1] == "done"
    assert asked == ["llama3-8b"]
