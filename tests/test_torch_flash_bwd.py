"""The port's attention backward on the CPU, against the JAX package.

``ref.flash_attention_bwd_ref`` (the plain twin of the backward kernel:
explicit formulas from the forward's output and row logsumexp) and
``ops.flash_attention``'s gradient on CPU tensors are held against
``jax.vjp`` through the reference's ``ops.flash_attention`` (its Pallas
forward in interpret mode, its ``_fa_bwd`` recomputing through
``attention_ref``) and through ``models.layers.chunked_attention``, what
the reference's training path differentiates.  The same cotangent, made
with numpy from a seed, goes into both.  Each row's logsumexp
(``attention_ref(..., return_lse=True)``, ``flash_attention_fwd``'s CPU
path) is held against a float64 numpy logsumexp of the masked scores.

Tolerances: 1e-4 in float32 and 2e-2 in bfloat16 (atol and rtol, the
port's bars against the reference), lse 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (_bwd_head_split,
                                                 _flash_attention_bwd,
                                                 flash_attention_fwd)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}

# (causal, window, batch, q heads, kv heads, S, D): every mask (causal,
# windowed, bidirectional, bidirectional with a window), groups of 1, 2
# and 4 q heads a kv head, head dims 64, 128 and 256, S ragged against the
# kernel's 64-row tiles up to 500
CASES = {
    "causal_g1_d64": (True, 0, 2, 2, 2, 128, 64),
    "causal_g4_d128": (True, 0, 1, 4, 1, 256, 128),
    "causal_g2_s500": (True, 0, 1, 2, 1, 500, 64),
    "window16_g2_s200": (True, 16, 2, 4, 2, 200, 64),
    "window64_g2_d256_s130": (True, 64, 1, 2, 1, 130, 256),
    "bidirectional_g2_d128_s96": (False, 0, 1, 4, 2, 96, 128),
    "bidirectional_g1_d256": (False, 0, 1, 2, 2, 64, 256),
    "bidirectional_window24_g4_s77": (False, 24, 1, 4, 1, 77, 64),
}


def _arrays(seed, b, h, hkv, s, d):
    """q, k, v and an upstream gradient, float32 numpy from a seed."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d),
                          (b, h, s, d))]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(name, dtype):
    causal, window, b, h, hkv, s, d = CASES[name]
    jd, td, tol = DTYPES[dtype]
    arrays = _arrays(sum(CASES[name][2:]) + window, b, h, hkv, s, d)
    return (causal, window, [jnp.asarray(a, jd) for a in arrays],
            [torch.as_tensor(a).to(td) for a in arrays], tol)


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_matches_the_reference_flash_vjp(name, dtype):
    """The plain twin and ``ops.flash_attention``'s autograd against
    ``jax.vjp`` through the reference's flash op (Pallas interpret)."""
    causal, window, jx, tx, tol = _inputs(name, dtype)
    _, vjp = jax.vjp(
        lambda q, k, v: jops.flash_attention(q, k, v, causal, window, True),
        *jx[:3])
    want = vjp(jx[3])
    q, k, v, do = tx
    o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                 return_lse=True)
    before = _flash_attention_bwd.launches
    got = tref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window)
    assert [t.dtype for t in got] == [q.dtype] * 3
    _close(got, want, tol)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tops.flash_attention(*leaves, causal, window)
    _close(torch.autograd.grad(out, leaves, do), want, tol)
    assert _flash_attention_bwd.launches == before  # CPU: no kernel


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_matches_chunked_attention_grad(name, dtype):
    """``ops.flash_attention``'s gradient against ``jax.vjp`` through the
    reference's chunked attention ((B, S, H, D) operands)."""
    causal, window, jx, tx, tol = _inputs(name, dtype)

    def chunked(q, k, v):
        out = jlayers.chunked_attention(
            *(jnp.swapaxes(t, 1, 2) for t in (q, k, v)), causal=causal,
            window=window)
        return jnp.swapaxes(out, 1, 2)

    _, vjp = jax.vjp(chunked, *jx[:3])
    want = vjp(jx[3])
    leaves = [t.clone().requires_grad_() for t in tx[:3]]
    out = tops.flash_attention(*leaves, causal, window)
    _close(torch.autograd.grad(out, leaves, tx[3]), want, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_lse_matches_a_float64_logsumexp(name, dtype):
    causal, window, _, tx, _ = _inputs(name, dtype)
    q, k, v = tx[:3]
    _, lse = tref.attention_ref(q, k, v, causal=causal, window=window,
                                return_lse=True)
    _, lse_fwd = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    qd, kd = (t.double().numpy() for t in (q, k))
    b, h, s, d = qd.shape
    kd = np.repeat(kd, h // kd.shape[1], axis=1)
    scores = np.einsum("bhqd,bhkd->bhqk", qd, kd) / np.sqrt(d)
    i = np.arange(s)
    mask = np.ones((s, s), bool)
    if causal:
        mask &= i[:, None] >= i[None, :]
    if window > 0:
        mask &= (i[:, None] - i[None, :]) < window
    scores = np.where(mask, scores, -np.inf)
    top = scores.max(axis=-1, keepdims=True)
    want = (top + np.log(np.exp(scores - top).sum(axis=-1, keepdims=True))
            )[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=0)
    torch.testing.assert_close(lse_fwd, lse, atol=0, rtol=0)


def test_strided_upstream_gradient_is_copied():
    """The layers hand the op a transposed view's gradient: the dispatcher
    copies it to a contiguous tensor first, and the result is the same."""
    causal, window, _, tx, _ = _inputs("window16_g2_s200", "float32")
    q, k, v, do = tx
    o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                 return_lse=True)
    strided = do.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous()
    got = tops.flash_attention_bwd(q, k, v, o, lse, strided, causal, window)
    want = tref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                        window=window)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


# (B, H, Hkv, S, D, bf16, SMs) -> over how many blocks the bf16 dK/dV pass
# splits each group's q heads: the main paths' training shapes on the
# H100's 132 SMs (the griffin smoke config's in train_sharded and
# elastic), float32 (never split), uneven splits and a smaller card
HEAD_SPLITS = {
    "llama3_8b_train": ((1, 32, 8, 4096, 128, True, 132), 1),
    "qwen_moe_train": ((1, 16, 16, 4096, 128, True, 132), 1),
    "whisper_encoder_one_head_a_group": ((1, 12, 12, 1024, 64, True, 132), 1),
    "griffin_train": ((1, 10, 1, 4096, 256, True, 132), 5),
    "griffin_smoke": ((2, 4, 1, 256, 64, True, 132), 4),
    "float32_never": ((2, 4, 1, 256, 64, False, 132), 1),
    "g10_over_3": ((3, 30, 3, 1200, 128, True, 132), 3),
    "g10_over_9_d256": ((2, 10, 1, 1000, 256, True, 132), 9),
    "g6_over_5": ((1, 24, 4, 2048, 128, True, 132), 5),
    "at_most_a_part_a_head": ((1, 4, 1, 129, 256, True, 132), 4),
    "griffin_on_16_sms": ((1, 10, 1, 4096, 256, True, 16), 1),
}


@pytest.mark.parametrize("name", sorted(HEAD_SPLITS))
def test_backward_head_split(name):
    args, want = HEAD_SPLITS[name]
    assert _bwd_head_split(*args) == want


@pytest.mark.parametrize("g", [1, 4, 6, 10])
def test_backward_head_split_parts_cover_the_group(g):
    """Part j of ``split`` takes q heads [j G / split, (j + 1) G / split),
    as the dK/dV kernel reads them: every head exactly once, no part
    empty, for every split the wrapper may pick."""
    for split in range(1, g + 1):
        parts = [range(j * g // split, (j + 1) * g // split)
                 for j in range(split)]
        assert all(len(p) > 0 for p in parts)
        assert [h for p in parts for h in p] == list(range(g))
