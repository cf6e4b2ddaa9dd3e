"""The port's encdec family (the Whisper-small backbone: a bidirectional
encoder over stub frame embeddings, a causal decoder with cross-attention)
against the JAX package's.

Both packages run on the same weights: the JAX init's parameters, carried
over with ``params_from_jax``, the same numpy token streams and the same
numpy frames, ``S // enc_frames_ratio`` of them a sequence.  The smoke
config runs in float32 (1e-4) and bfloat16 (2e-2), as
``tests/test_torch_dense.py`` holds the dense family: parameters, forward
logits, ``loss_fn`` and per-leaf gradients, prefill, decode and one
``build_train_step`` step on a batch that carries frames (as
``tests/test_models.py`` gives them).  The reference's training driver
feeds no frames to this family (ROADMAP C5); the port's fails the same way.
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
from test_torch_dense import DTYPES, _close, _normwise, _np, _tokens
from test_torch_moe import _reference_count, _shape_count

ARCH = "whisper_small"
B = 2
N_DECODE = 3


def _configs(dtype: str):
    jd, td, _ = DTYPES[dtype]
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), dtype=jd,
                               param_dtype=jd)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype=td,
                               param_dtype=td)
    return jcfg, tcfg


def _frames(seed: int, cfg, b: int, s: int) -> np.ndarray:
    n = max(s // cfg.enc_frames_ratio, 1)
    return np.random.default_rng(seed).standard_normal(
        (b, n, cfg.d_model)).astype(np.float32)


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
    # layernorms in the layers and after the encoder, rmsnorm before the head
    assert set(tparams["ln_enc"]) == {"scale", "bias"}
    assert set(tparams["dec"]["ln_cross"]) == {"scale", "bias"}
    assert set(tparams["ln_f"]) == {"scale"}


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


def test_forward_logits(pair):
    dtype, jcfg, jparams, tcfg, tparams = pair
    s = 16
    toks = _tokens(1, jcfg.vocab, B, s)
    fr = _frames(1, jcfg, B, s)
    want, jaux = jax.jit(lambda p, t, f: jmodels.forward(p, jcfg, t, frames=f))(
        jparams, jnp.asarray(toks, jnp.int32), jnp.asarray(fr))
    got, aux = tmodels.forward(tparams, tcfg, torch.as_tensor(toks),
                               frames=torch.as_tensor(fr))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, s, 512)
    assert float(aux) == float(jaux) == 0.0
    _close(got, want, DTYPES[dtype][2], "forward logits")


def _batch(cfg, b=4, s=16, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab, (b, s))
    labels = rng.integers(1, cfg.vocab, (b, s))
    labels[0, :5] = -1  # masked
    fr = _frames(seed + 7, cfg, b, s)
    jb = {"tokens": jnp.asarray(tokens, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32),
          "frames": jnp.asarray(fr)}
    tb = {"tokens": torch.as_tensor(tokens), "labels": torch.as_tensor(labels),
          "frames": torch.as_tensor(fr)}
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
    """Prefill builds the decoder's cache and replaces ``init_cache``'s
    ``enc_out`` (max_len // 4 = 5 frames) with the prompt's 3."""
    dtype, jcfg, jparams, tcfg, tparams = pair
    tol = DTYPES[dtype][2]
    s = 12
    max_len = s + N_DECODE + 5
    toks = _tokens(2, jcfg.vocab, B, s + N_DECODE)
    fr = _frames(2, jcfg, B, s)
    jl, jc = jax.jit(lambda p, t, f: jmodels.prefill(
        p, jcfg, t, frames=f, max_len=max_len))(
            jparams, jnp.asarray(toks[:, :s], jnp.int32), jnp.asarray(fr))
    tl, tc = tmodels.prefill(tparams, tcfg, torch.as_tensor(toks[:, :s]),
                             frames=torch.as_tensor(fr), max_len=max_len)
    _close(tl, jl, tol, "prefill last logits")
    assert set(tc) == set(jc) == {"k", "v", "enc_out", "index"}
    assert tuple(tc["enc_out"].shape) == tuple(jc["enc_out"].shape) == (
        B, s // 4, 64)
    assert tuple(tmodels.init_cache(tcfg, B, max_len, device="cpu")[
        "enc_out"].shape) == (B, max_len // 4, 64)
    for key in sorted(jc):
        assert tuple(tc[key].shape) == tuple(jc[key].shape), key
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


def test_init_cache_equals_the_reference():
    jcfg, tcfg = _configs("bfloat16")
    jc = jmodels.init_cache(jcfg, 3, 32)
    tc = tmodels.init_cache(tcfg, 3, 32, device="cpu")
    assert set(tc) == set(jc)
    for key in jc:
        assert tuple(tc[key].shape) == tuple(jc[key].shape), key
        assert str(tc[key].dtype).removeprefix("torch.") == \
            jnp.dtype(jc[key].dtype).name, key


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_prefill_then_decode_matches_forward(dtype):
    """Teacher forcing (``tests/test_models.py``'s check for
    whisper_small): prefill's last logits and each decode step's equal the
    training forward's at the same position, on the same frames."""
    jcfg, tcfg = _configs(dtype)
    jparams, _ = jmodels.init_model(jcfg, jax.random.PRNGKey(0))
    tparams = tmodels.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jparams), tcfg,
        "cpu")
    tol = DTYPES[dtype][2]
    s = 16
    toks = torch.as_tensor(_tokens(3, tcfg.vocab, B, s + N_DECODE))
    fr = torch.as_tensor(_frames(3, tcfg, B, s + N_DECODE))
    full, _ = tmodels.forward(tparams, tcfg, toks, frames=fr)
    logits, cache = tmodels.prefill(tparams, tcfg, toks[:, :s], frames=fr,
                                    max_len=s + 4)
    _close(logits[:, 0], full[:, s - 1], tol, "prefill vs forward")
    for t in range(s, s + N_DECODE):
        logits, cache = tmodels.decode_step(tparams, tcfg, cache,
                                            toks[:, t:t + 1])
        _close(logits[:, 0], full[:, t], tol, f"decode vs forward at {t}")


def test_train_step_matches_the_reference():
    """One bf16 train step of each package from the same state and a batch
    that carries frames (2 micro-batches, the frames split with the
    tokens), held as the dense family's step is."""
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


def test_prefill_step_passes_the_frames():
    jcfg, tcfg = _configs("float32")
    params = tmodels.init_model(tcfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.as_tensor(_tokens(4, tcfg.vocab, B, 8))
    fr = torch.as_tensor(_frames(4, tcfg, B, 8))
    got, cache = tsteps.build_prefill_step(tcfg)(
        params, {"tokens": toks, "frames": fr})
    want, _ = tmodels.prefill(params, tcfg, toks, frames=fr)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tuple(cache["enc_out"].shape) == (B, 2, 64)


def test_forward_without_frames_names_them():
    _, tcfg = _configs("float32")
    params = tmodels.init_model(tcfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((1, 8), dtype=torch.long)
    for call in (lambda: tmodels.forward(params, tcfg, toks),
                 lambda: tmodels.prefill(params, tcfg, toks)):
        with pytest.raises(ValueError, match="frames"):
            call()


def test_train_driver_gives_encdec_no_frames():
    """ROADMAP C5: the reference's ``SyntheticLM`` batches carry tokens and
    labels only, so its training driver cannot feed this family; the
    port's fails the same way, naming the missing frames."""
    from repro_torch.launch import train
    with pytest.raises(ValueError, match="frames"):
        train.main(["--device", "cpu", "--arch", "whisper-small",
                    "--steps", "1", "--batch", "2", "--seq", "16"])


def test_serve_driver_gives_frames(capsys):
    """The serving driver draws each batch's frames, (B, prompt_len // 4,
    d_model), as the reference's does."""
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--arch", "whisper-small", "--requests",
                "4", "--batch", "2", "--prompt-len", "12", "--gen", "3"])
    assert "served 4 requests, 12 tokens" in capsys.readouterr().out
    cfg = tconfigs.get_smoke_config("whisper-small")
    frames = serve.make_frames(cfg, 4, 2, 12, torch.Generator(), "cpu")
    assert [tuple(f.shape) for f in frames] == [(2, 3, 64)] * 2
    assert serve.make_frames(tconfigs.get_smoke_config("llama3-8b"), 4, 2, 12,
                             torch.Generator(), "cpu") is None


def test_full_config_equals_the_reference():
    jcfg = jconfigs.get_config("whisper-small")
    tcfg = tconfigs.get_config("whisper-small")
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
    for alias in (ARCH, "whisper-small"):
        assert tconfigs.canonical(alias) == jconfigs.canonical(alias) == ARCH


def test_full_parameter_count_equals_the_reference(monkeypatch):
    n = _shape_count(tconfigs.get_config("whisper-small"), monkeypatch)
    assert n == _reference_count("whisper-small") == 334_563_072
