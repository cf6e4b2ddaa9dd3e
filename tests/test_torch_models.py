"""The port's griffin model (RecurrentGemma) against the JAX package's.

Both packages run on the same weights: the JAX init's parameters, carried
over with ``params_from_jax``, and the same numpy token streams.  The
smoke config gets two extra RG-LRU layers (8 layers: 2 groups and a tail of
2) so that the tail path is compared too.  Tolerances: 1e-4 in float32 (the
RG-LRU runs as a sequential loop here and as an associative scan in JAX,
and the chunk orders differ), 2e-2 in bfloat16 (the bf16 tolerance of
``tests/test_models.py``).

A prompt of 24 tokens is longer than the smoke window of 16: prefill masks
by the window, and decode after prefill attends over every earlier
position, in both packages (ROADMAP C3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.models import layers as jlayers
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.models import layers as tlayers

ARCH = "recurrentgemma_2b"
B = 2
N_DECODE = 3

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _configs(dtype: str, n_layers: int = 8):
    jd, td, _ = DTYPES[dtype]
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), dtype=jd,
                               param_dtype=jd, n_layers=n_layers)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype=td,
                               param_dtype=td, n_layers=n_layers)
    return jcfg, tcfg


def _pair(dtype: str, seed: int = 0):
    jcfg, tcfg = _configs(dtype)
    jparams, _ = jmodels.init_model(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), jparams)
    return jcfg, jparams, tcfg, tmodels.params_from_jax(tree, tcfg, "cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, what):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol,
                               err_msg=what)


def _tokens(seed, vocab, b, s):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


@pytest.fixture(scope="module", params=sorted(DTYPES))
def pair(request):
    return (request.param, *_pair(request.param))


def test_params_carried_over(pair):
    dtype, jcfg, jparams, tcfg, tparams = pair
    assert tmodels.param_count(tparams) == jmodels.param_count(jparams)
    assert tparams["groups"]["rg1"]["block"]["lam"].dtype == torch.float32
    assert tparams["embed"].dtype == DTYPES[dtype][1]
    assert tuple(tparams["tail"]["block"]["w_a"].shape) == (2, 64, 64)


@pytest.mark.parametrize("s", [12, 24])
def test_forward_logits(pair, s):
    dtype, jcfg, jparams, tcfg, tparams = pair
    toks = _tokens(1, jcfg.vocab, B, s)
    want, _ = jmodels.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32))
    got, aux = tmodels.forward(tparams, tcfg, torch.as_tensor(toks))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, s, 512)
    assert aux.dtype == torch.float32 and aux.dim() == 0 and float(aux) == 0.0
    _close(got, want, DTYPES[dtype][2], "forward logits")


@pytest.mark.parametrize("s", [12, 24])
def test_prefill_and_decode(pair, s):
    dtype, jcfg, jparams, tcfg, tparams = pair
    tol = DTYPES[dtype][2]
    toks = _tokens(2, jcfg.vocab, B, s + N_DECODE)
    max_len = s + N_DECODE + 1
    jl, jc = jmodels.prefill(jparams, jcfg, jnp.asarray(toks[:, :s], jnp.int32),
                             max_len=max_len)
    tl, tc = tmodels.prefill(tparams, tcfg, torch.as_tensor(toks[:, :s]),
                             max_len=max_len)
    _close(tl, jl, tol, "prefill last logits")
    assert set(tc) == set(jc)
    for key in sorted(jc):
        _close(tc[key], jc[key], tol, f"prefill cache {key}")
    for t in range(s, s + N_DECODE):
        step = toks[:, t:t + 1]
        jl, jc = jmodels.decode_step(jparams, jcfg, jc,
                                     jnp.asarray(step, jnp.int32))
        tl, tc = tmodels.decode_step(tparams, tcfg, tc, torch.as_tensor(step))
        _close(tl, jl, tol, f"decode logits at {t}")
    for key in sorted(jc):
        _close(tc[key], jc[key], tol, f"decode cache {key}")
    assert int(tc["index"]) == int(jc["index"]) == s + N_DECODE


def test_decode_matches_forward_within_the_window():
    """Teacher forcing: while prompt + generated tokens fit in the window,
    decode after prefill gives forward's logits (ROADMAP C3: past it, the
    full-length cache makes them differ, in the JAX package too)."""
    _, _, tcfg, tparams = _pair("float32")
    s = 12
    toks = torch.as_tensor(_tokens(3, tcfg.vocab, B, s + N_DECODE))
    full, _ = tmodels.forward(tparams, tcfg, toks)
    logits, cache = tmodels.prefill(tparams, tcfg, toks[:, :s],
                                    max_len=s + N_DECODE)
    _close(logits[:, 0], full[:, s - 1], 1e-4, "prefill vs forward")
    for t in range(s, s + N_DECODE - 1):
        logits, cache = tmodels.decode_step(tparams, tcfg, cache,
                                            toks[:, t:t + 1])
        _close(logits[:, 0], full[:, t], 1e-4, f"decode vs forward at {t}")


def test_full_config_equals_the_reference():
    jcfg = jconfigs.get_config("recurrentgemma-2b")
    tcfg = tconfigs.get_config("recurrentgemma-2b")
    for f in dataclasses.fields(jcfg):
        a, b = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name in ("dtype", "param_dtype", "logit_dtype"):
            assert jnp.dtype(a).name == str(b).removeprefix("torch."), f.name
        else:
            assert a == b, f.name
    assert tcfg.pattern() == jcfg.pattern()
    assert tconfigs.canonical("recurrentgemma-2b") == "recurrentgemma_2b"
    assert set(tconfigs.ARCHS) == set(jconfigs.ARCHS)


def test_unknown_family_raises_value_error():
    """As the JAX package's ``init_model`` does for a family it lacks."""
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH),
                               family="mamba")
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               family="mamba")
    with pytest.raises(ValueError, match="mamba"):
        jmodels.init_model(jcfg, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="mamba"):
        tmodels.init_model(tcfg, torch.Generator(), "cpu")
    with pytest.raises(ValueError, match="mamba"):
        tmodels.init_cache(tcfg, 1, 8, device="cpu")


def test_unknown_arch_raises_key_error():
    """As the JAX package's registry does."""
    for registry in (jconfigs, tconfigs):
        for fn in (registry.get_config, registry.get_smoke_config,
                   registry.canonical):
            with pytest.raises(KeyError):
                fn("gpt-5")


def test_init_model_shapes_scales_and_device():
    jcfg, tcfg = _configs("float32")
    jparams, _ = jmodels.init_model(jcfg, jax.random.PRNGKey(0))
    tparams = tmodels.init_model(tcfg, torch.Generator().manual_seed(0),
                                 "cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in jflat:
        node = tparams
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        std = float(np.std(np.asarray(leaf)))
        if leaf.size > 256 and std > 0:  # random leaves: same scale
            assert float(node.std()) == pytest.approx(std, rel=0.15), path
    assert float(tparams["groups"]["rg1"]["block"]["w_x"].abs().max()) <= 0.04
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="is_available"):
            tmodels.init_model(tcfg, torch.Generator())


def test_chunked_attention_and_mrope_match_the_reference():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    for causal, window in ((True, 0), (True, 8), (False, 0)):
        want = jlayers.chunked_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            q_offset=jnp.asarray([16, 32]), window=window,
            kv_len=jnp.asarray([40, 64]), chunk=16)
        got = tlayers.chunked_attention(
            torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
            causal=causal, q_offset=torch.tensor([16, 32]), window=window,
            kv_len=torch.tensor([40, 64]), chunk=16)
        _close(got, want, 1e-5, f"chunked attention {causal} {window}")
    pos = rng.integers(0, 50, (3, 2, 32))
    want = jlayers.apply_mrope(jnp.asarray(q), jnp.asarray(pos), 1e4, (2, 3, 3))
    got = tlayers.apply_mrope(torch.as_tensor(q), torch.as_tensor(pos), 1e4,
                              (2, 3, 3))
    _close(got, want, 1e-5, "mrope")
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    p = {"scale": rng.standard_normal(16).astype(np.float32),
         "bias": rng.standard_normal(16).astype(np.float32)}
    want = jlayers.layernorm({k_: jnp.asarray(a) for k_, a in p.items()},
                             jnp.asarray(x))
    got = tlayers.layernorm({k_: torch.as_tensor(a) for k_, a in p.items()},
                            torch.as_tensor(x))
    _close(got, want, 1e-5, "layernorm")
