"""The RG-LRU recurrence's gradient in the port, on the CPU.

``ops.rg_lru`` is a ``torch.autograd.Function``: its forward is the RG-LRU
kernel's wrapper (the plain loop for CPU tensors), its backward
``ops.rg_lru_bwd``, the adjoint recurrence run backward in time (the
backward kernel for CUDA tensors, ``ref.rg_lru_bwd_ref`` here).  Both
round every multiply and add apart, as autograd through the plain forward
loop does, so the gradients must be equal bit for bit (``torch.equal``).
Against the JAX package, whose model differentiates an associative scan,
the gradient is held to 1e-5 relative (another summation order).

The backward kernel itself is held to ``ref.rg_lru_bwd_ref`` on the card
(``tests/test_torch_train_cuda.py`` and ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.rg_lru import _rg_lru_pallas_bwd

SHAPES = [(1, 1, 5), (1, 37, 33), (3, 65, 8), (2, 130, 40)]


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.6, 0.99, shape).astype(np.float32)
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    return a, x, g


def _autograd_plain(a, x, g):
    at = torch.tensor(a, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    y = ref.rg_lru_ref(at, xt)
    da, dx = torch.autograd.grad(y, (at, xt), torch.tensor(g))
    return y.detach(), da, dx


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_function_backward_is_autograd_through_the_plain_loop(shape):
    a, x, g = _inputs(sum(shape), shape)
    y_want, da_want, dx_want = _autograd_plain(a, x, g)
    at = torch.tensor(a, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    y = ops.rg_lru(at, xt)
    assert y.grad_fn is not None
    assert torch.equal(y, y_want)
    da, dx = torch.autograd.grad(y, (at, xt), torch.tensor(g))
    assert torch.equal(da, da_want)
    assert torch.equal(dx, dx_want)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_backward_is_autograd_through_the_plain_loop(shape):
    a, x, g = _inputs(sum(shape) + 1, shape)
    y, da_want, dx_want = _autograd_plain(a, x, g)
    da, dx = ref.rg_lru_bwd_ref(torch.tensor(a), y, torch.tensor(g))
    assert torch.equal(da, da_want)
    assert torch.equal(dx, dx_want)
    # the first step's state is zero: no gradient reaches a_0
    assert not da[:, 0].any()


def test_backward_dispatch_copies_strided_inputs():
    a, x, g = _inputs(3, (2, 40, 24))
    y, da_want, dx_want = _autograd_plain(a, x, g)
    # g as a transposed view of a (B, W, S) buffer: same values, strided
    g_strided = torch.tensor(np.ascontiguousarray(g.transpose(0, 2, 1))
                             ).transpose(1, 2)
    assert not g_strided.is_contiguous()
    da, dx = ops.rg_lru_bwd(torch.tensor(a), y, g_strided)
    assert torch.equal(da, da_want) and torch.equal(dx, dx_want)


def test_cpu_tensors_take_the_plain_backward_uncounted():
    a, x, g = _inputs(4, (1, 9, 7))
    before = _rg_lru_pallas_bwd.launches
    y, da_want, dx_want = _autograd_plain(a, x, g)
    da, dx = _rg_lru_pallas_bwd(torch.tensor(a), y, torch.tensor(g))
    assert torch.equal(da, da_want) and torch.equal(dx, dx_want)
    assert _rg_lru_pallas_bwd.launches == before


def test_only_the_needed_gradient():
    a, x, g = _inputs(5, (2, 12, 6))
    _, _, dx_want = _autograd_plain(a, x, g)
    xt = torch.tensor(x, requires_grad=True)
    y = ops.rg_lru(torch.tensor(a), xt)
    (dx,) = torch.autograd.grad(y, (xt,), torch.tensor(g))
    assert torch.equal(dx, dx_want)


def _assoc_scan(a, x):
    """The JAX package's model recurrence (``models/recurrent.rg_lru_scan``):
    an associative scan with its combine."""
    def combine(c1, c2):
        a1, x1 = c1
        a2, x2 = c2
        return a1 * a2, a2 * x1 + x2
    return jax.lax.associative_scan(combine, (a, x), axis=1)[1]


@pytest.mark.parametrize("jax_fn", [jref.rg_lru_ref, _assoc_scan],
                         ids=["lax_scan_oracle", "associative_scan"])
def test_gradient_matches_the_reference(jax_fn):
    a, x, g = _inputs(6, (2, 50, 16))
    jda, jdx = jax.jit(jax.grad(
        lambda a, x: jnp.sum(jax_fn(a, x) * g), argnums=(0, 1)))(
            jnp.asarray(a), jnp.asarray(x))
    at = torch.tensor(a, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    da, dx = torch.autograd.grad((ops.rg_lru(at, xt) * torch.tensor(g)).sum(),
                                 (at, xt))
    for got, want in ((da, jda), (dx, jdx)):
        want = np.asarray(want)
        err = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert err <= 1e-5, err
