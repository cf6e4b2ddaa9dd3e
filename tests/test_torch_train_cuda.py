"""The port's training path on the card: the RG-LRU backward kernel, the
griffin model's gradients and the training entry point.

Every test here is marked ``cuda`` and skips (with its reason) where no CUDA
device is present: a CUDA kernel has no CPU build.  The file imports only
numpy, torch and the port, so it runs on a GPU machine that has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_cuda.py

Tolerances: the RG-LRU backward kernel bit for bit (``torch.equal``) with
its plain reverse loop (both round every multiply and add apart); the
model's per-leaf gradients on the card within 1e-4 normwise of the same
model's on the CPU in float32 (another attention kernel, matmul library
and summation order), and within 2e-2 in bfloat16 (the bf16 tolerance of
the CPU tests against the JAX package).
"""
import dataclasses
import threading

import pytest
import torch

from repro_torch import _tree
from repro_torch import configs
from repro_torch import models
from repro_torch.checkpoint import latest_step
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.rg_lru import _rg_lru_pallas_bwd, rg_lru_pallas
from repro_torch.launch import train as ttrain

GRAD_TOL = 1e-4  # float32, normwise per leaf
GRAD_TOL_BF16 = 2e-2  # bfloat16, normwise per leaf

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bwd_inputs(seed, shape, device):
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.sigmoid(torch.randn(shape, generator=g, device=device)) \
        * 0.3 + 0.65
    x = torch.randn(shape, generator=g, device=device)
    return a, ref.rg_lru_ref(a, x), torch.randn(shape, generator=g,
                                                device=device)


def _skewed(t):
    """``t``'s values in a contiguous view 4 bytes past a 16-byte boundary
    (a ``[1:]`` slice of a larger buffer), which TMA cannot read."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


# S = 1; S = 64k + 1 (one step past whole 64-step tiles); S = 8 * 64 + 1
# (one step past a full 8-stage ring); W not a multiple of the 16-column
# block (a ragged last block, TMA's zero fill); W % 4 != 0 and an operand
# off 16 bytes (4-byte copies); B up to 8, and 3 at W = 2560; the training
# shape
@pytest.mark.parametrize("b,s,w,skew", [
    (1, 1, 64, None), (2, 65, 40, None), (1, 129, 2568, None),
    (8, 200, 96, None), (3, 37, 33, None), (1, 4096, 2560, None),
    (2, 1001, 1000, None), (2, 300, 1001, None), (1, 513, 2560, None),
    (3, 300, 2560, None), (2, 65, 64, "g"), (1, 600, 256, "a"),
    (2, 130, 48, "y")])
def test_rg_lru_bwd_kernel_matches_plain(cuda, b, s, w, skew):
    a, y, g = _bwd_inputs(b + s + w, (b, s, w), cuda)
    if skew == "a":
        a = _skewed(a)
    elif skew == "y":
        y = _skewed(y)
    elif skew == "g":
        g = _skewed(g)
    before = _rg_lru_pallas_bwd.launches
    da, dx = _rg_lru_pallas_bwd(a, y, g)
    torch.cuda.synchronize()
    assert _rg_lru_pallas_bwd.launches == before + 1
    da_want, dx_want = ref.rg_lru_bwd_ref(a, y, g)
    assert torch.equal(dx, dx_want)
    assert torch.equal(da, da_want)


def test_rg_lru_bwd_kernel_on_a_fresh_thread(cuda):
    """Launched from a thread that has made no CUDA runtime call yet, as
    autograd's device thread can be when this backward is the first node
    it runs: the launch binds a context before it encodes its tensor
    maps."""
    a, y, g = _bwd_inputs(4, (2, 300, 96), cuda)
    _rg_lru_pallas_bwd(a, y, g)  # its freed outputs stay cached
    torch.cuda.synchronize()
    out = {}

    def launch():
        try:
            out["got"] = _rg_lru_pallas_bwd(a, y, g)
        except RuntimeError as e:
            out["error"] = e

    thread = threading.Thread(target=launch)
    thread.start()
    thread.join(timeout=120)
    assert not thread.is_alive()
    assert "error" not in out, out.get("error")
    torch.cuda.synchronize()
    da_want, dx_want = ref.rg_lru_bwd_ref(a, y, g)
    assert torch.equal(out["got"][0], da_want)
    assert torch.equal(out["got"][1], dx_want)


def test_rg_lru_bwd_strided_inputs_copied_or_refused(cuda):
    a, y, g = _bwd_inputs(1, (2, 70, 64), cuda)
    g_strided = g.transpose(1, 2).contiguous().transpose(1, 2)
    assert not g_strided.is_contiguous()
    with pytest.raises(ValueError, match="not contiguous"):
        _rg_lru_pallas_bwd(a, y, g_strided)
    before = _rg_lru_pallas_bwd.launches
    da, dx = ops.rg_lru_bwd(a, y, g_strided)  # the dispatcher copies
    assert _rg_lru_pallas_bwd.launches == before + 1
    da_want, dx_want = ref.rg_lru_bwd_ref(a, y, g)
    assert torch.equal(da, da_want) and torch.equal(dx, dx_want)


def test_rg_lru_bwd_refuses_other_dtypes(cuda):
    a, y, g = _bwd_inputs(2, (1, 16, 32), cuda)
    with pytest.raises(ValueError, match="dtype|float"):
        _rg_lru_pallas_bwd(a, y, g.double())


def test_rg_lru_op_is_differentiable_through_the_kernels(cuda):
    a, x = _bwd_inputs(3, (2, 300, 96), cuda)[:2]
    g = torch.randn_like(a)
    at, xt = a.clone().requires_grad_(), x.clone().requires_grad_()
    f0, b0 = rg_lru_pallas.launches, _rg_lru_pallas_bwd.launches
    y = ops.rg_lru(at, xt)
    assert y.grad_fn is not None
    da, dx = torch.autograd.grad(y, (at, xt), g)
    assert (rg_lru_pallas.launches, _rg_lru_pallas_bwd.launches) == \
        (f0 + 1, b0 + 1)
    # autograd through the plain loop on the card: the same roundings
    ap, xp = a.clone().requires_grad_(), x.clone().requires_grad_()
    da_want, dx_want = torch.autograd.grad(ref.rg_lru_ref(ap, xp), (ap, xp),
                                           g)
    assert torch.equal(da, da_want) and torch.equal(dx, dx_want)


def _grads(params, cfg, batch):
    xs = [p.detach().requires_grad_() for p in _tree.leaves(params)]
    loss, _ = models.loss_fn(_tree.rebuild(params, xs), cfg, batch)
    return float(loss.detach()), torch.autograd.grad(loss, xs)


def _full_width_grads_vs_cpu(device, dtype, tol, loss_tol):
    """RecurrentGemma-2B at full width, one group deep (two RG-LRU and one
    attention sublayer, d_head 256, vocab 256,000), seq 512, in ``dtype``:
    every leaf's gradient on the card (flash and RG-LRU kernels forward,
    the backward kernel, remat) against the same model's on the CPU, and
    non-zero."""
    cfg = dataclasses.replace(configs.get_config("recurrentgemma-2b"),
                              n_layers=3, dtype=dtype, param_dtype=dtype)
    params = models.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (1, 512), generator=g)
    labels = torch.randint(0, cfg.vocab, (1, 512), generator=g)
    batch = {"tokens": tokens, "labels": labels}
    loss_cpu, want = _grads(params, cfg, batch)
    params = _tree.tree_map(lambda t: t.to(device), params)
    before = (flash_attention_fwd.launches, rg_lru_pallas.launches,
              _rg_lru_pallas_bwd.launches)
    loss, got = _grads(params, cfg,
                       {k: v.to(device) for k, v in batch.items()})
    after = (flash_attention_fwd.launches, rg_lru_pallas.launches,
             _rg_lru_pallas_bwd.launches)
    # remat: forward and recompute of 1 attention and 2 RG-LRU sublayers
    assert [b - a for a, b in zip(before, after)] == [2, 4, 2]
    assert abs(loss - loss_cpu) <= loss_tol * abs(loss_cpu)
    names = [name for name, _ in _named_leaves(params)]
    errs = {}
    for name, a, b in zip(names, got, want):
        errs[name] = float(torch.linalg.vector_norm(a.cpu().float()
                                                    - b.float())
                           / torch.linalg.vector_norm(b.float()))
        assert float(torch.linalg.vector_norm(a.float())) > 0, name
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, f"{worst}: normwise {errs[worst]}"
    return errs


def test_full_width_gradients_match_the_cpu(cuda):
    """float32, within 1e-4 normwise per leaf, the loss within 1e-5."""
    _full_width_grads_vs_cpu(cuda, torch.float32, GRAD_TOL, 1e-5)


def test_full_width_bf16_gradients_match_the_cpu(cuda):
    """bfloat16, the training path's dtype (the flash kernel's wgmma body,
    the float32 LM head at vocab 256,000), within 2e-2 normwise per leaf:
    the bf16 tolerance the CPU tests hold the port to against the JAX
    package (the loss too)."""
    errs = _full_width_grads_vs_cpu(cuda, torch.bfloat16, GRAD_TOL_BF16,
                                    GRAD_TOL_BF16)
    print("bf16 normwise gradient errors, card vs CPU:",
          {k: f"{v:.3g}" for k, v in sorted(errs.items())})


def _named_leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _named_leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def test_train_entry_point_on_the_card_checkpoints_and_resumes(cuda, tmp_path):
    cfg = dataclasses.replace(configs.get_smoke_config("recurrentgemma-2b"),
                              d_head=64)
    ckpt = str(tmp_path / "ckpt")
    before = _rg_lru_pallas_bwd.launches
    res = ttrain.train(cfg, steps=3, batch=8, seq=128, lr=3e-3,
                       ckpt_dir=ckpt, ckpt_every=2, device="cuda")
    assert res.start == 0 and len(res.losses) == 3
    assert all(torch.isfinite(torch.tensor(res.losses)))
    # 4 RG-LRU sublayers of the 6-layer smoke config, one backward each
    assert _rg_lru_pallas_bwd.launches - before == 3 * 4
    assert latest_step(ckpt) == 3
    res = ttrain.train(cfg, steps=5, batch=8, seq=128, lr=3e-3,
                       ckpt_dir=ckpt, device="cuda")
    assert res.start == 3 and len(res.losses) == 2
    assert all(torch.isfinite(torch.tensor(res.losses)))
    assert latest_step(ckpt) == 5
