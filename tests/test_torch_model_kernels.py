"""The port's model kernel ops, on the CPU, against the JAX package.

``ops.flash_attention`` here runs its plain version (a CPU tensor) and is
held against the reference's Pallas flash kernel in interpret mode, on
``TestFlashAttention``'s cases with S <= 256 (2e-5 in float32, 2e-2 in
bfloat16, 1e-4 on gradients through the ``autograd.Function``, whose
backward is the plain twin of the backward kernel on CPU tensors).
``ops.rg_lru`` is held against the reference's ``ref.rg_lru_ref`` and the
model's ``lax.associative_scan`` at 1e-4, not against the Pallas RG-LRU
kernel, which fails on this jax (ROADMAP C1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rg_lru as trg


def _qkv(seed, b, h, hkv, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def _both(arrays, jdtype=jnp.float32, tdtype=torch.float32):
    return ([jnp.asarray(a, jdtype) for a in arrays],
            [torch.as_tensor(a).to(tdtype) for a in arrays])


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 4])
def test_flash_causal_matches_pallas_interpret(s, d, g):
    jx, tx = _both(_qkv(s + d + g, 2, 4, 4 // g, s, d))
    want = jops.flash_attention(*jx, True, 0, True)
    got = tops.flash_attention(*tx, True, 0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        _f32(got), _f32(ref.attention_ref(*jx, causal=True)),
        atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal,window", [(True, 64), (False, 0)])
def test_flash_window_and_bidirectional(causal, window):
    jx, tx = _both(_qkv(7, 1, 2, 1 if window else 2, 256, 64))
    want = jops.flash_attention(*jx, causal, window, True)
    got = tops.flash_attention(*tx, causal, window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)


def test_flash_bf16():
    jx, tx = _both(_qkv(8, 1, 2, 2, 256, 64), jnp.bfloat16, torch.bfloat16)
    want = jops.flash_attention(*jx, True, 0, True)
    got = tops.flash_attention(*tx, True, 0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2, rtol=2e-2)


# (seed, causal, window, q heads, kv heads, S, D): the first case is the
# one this test held alone before the backward had its own formulas; the
# others take each mask and a ragged S through them
@pytest.mark.parametrize("seed,causal,window,h,hkv,s,d", [
    (9, True, 0, 2, 1, 128, 64),
    (10, True, 32, 4, 2, 100, 64),
    (11, False, 0, 2, 2, 96, 128),
    (12, False, 40, 4, 1, 130, 64),
])
def test_flash_gradients_match_jax_grad(seed, causal, window, h, hkv, s, d):
    arrays = _qkv(seed, 1, h, hkv, s, d)
    jx, tx = _both(arrays)

    def f_kernel(q_, k_, v_):
        return (jops.flash_attention(q_, k_, v_, causal, window, True)
                ** 2).sum()

    want = jax.grad(f_kernel, argnums=(0, 1, 2))(*jx)
    leaves = [t.requires_grad_() for t in tx]
    (tops.flash_attention(*leaves, causal, window) ** 2).sum().backward()
    for w, t in zip(want, leaves):
        np.testing.assert_allclose(_f32(t.grad), _f32(w), atol=1e-4,
                                   rtol=1e-4)


def _gates(seed, shape, lo):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal(shape))) * 0.3 + lo
    x = rng.standard_normal(shape)
    return a.astype(np.float32), x.astype(np.float32)


@pytest.mark.parametrize("s,w", [(256, 512), (512, 1024), (128, 2560)])
def test_rg_lru_matches_reference_oracle(s, w):
    a, x = _gates(s + w, (2, s, w), 0.65)
    got = tops.rg_lru(torch.as_tensor(a), torch.as_tensor(x))
    want = ref.rg_lru_ref(jnp.asarray(a), jnp.asarray(x))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-4, rtol=1e-4)


def test_rg_lru_matches_model_assoc_scan():
    a, x = _gates(11, (1, 256, 256), 0.6)

    def combine(c1, c2):
        a1, x1 = c1
        a2, x2 = c2
        return a1 * a2, a2 * x1 + x2

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                 jnp.asarray(x)), axis=1)
    got = tops.rg_lru(torch.as_tensor(a), torch.as_tensor(x))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-4, rtol=1e-4)


def test_rg_lru_ref_carries_h0_like_the_reference():
    a, x = _gates(12, (2, 16, 8), 0.6)
    h0 = np.random.default_rng(13).standard_normal((2, 8)).astype(np.float32)
    want = ref.rg_lru_ref(jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0))
    got = tref.rg_lru_ref(torch.as_tensor(a), torch.as_tensor(x),
                          torch.as_tensor(h0))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=1e-5)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    q, k, v = (torch.as_tensor(a) for a in _qkv(14, 1, 4, 1, 32, 64))
    before = (tflash.flash_attention_fwd.launches, trg.rg_lru_pallas.launches)
    out = tflash.flash_attention_fwd(q, k, v, causal=True, window=8)
    torch.testing.assert_close(
        out, tref.attention_ref(q, k, v, causal=True, window=8))
    a, x = (torch.as_tensor(t) for t in _gates(15, (1, 8, 4), 0.6))
    torch.testing.assert_close(trg.rg_lru_pallas(a, x), tref.rg_lru_ref(a, x))
    assert (tflash.flash_attention_fwd.launches,
            trg.rg_lru_pallas.launches) == before
