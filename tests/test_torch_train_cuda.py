"""The port's training path on the card: the attention and RG-LRU backward
kernels, the griffin model's gradients and the training entry point.

Every test here is marked ``cuda`` and skips (with its reason) where no CUDA
device is present: a CUDA kernel has no CPU build.  The file imports only
numpy, torch and the port, so it runs on a GPU machine that has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_cuda.py

Tolerances: the RG-LRU backward kernel bit for bit (``torch.equal``) with
its plain reverse loop (both round every multiply and add apart); the
attention backward kernel against its plain twin
(``ref.flash_attention_bwd_ref``, the same o and lse) within 1e-4 abs+rel
elementwise in float32 (other summation orders) and 2e-2 elementwise and
5e-3 normwise per gradient in bfloat16 (P and dS rounded to bf16 for the
tensor cores), the forward's lse within 1e-5 of the plain one's, and two
calls bit for bit (no atomics); the
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
from repro_torch.kernels.flash_attention import (_bwd_head_split,
                                                 _flash_attention_bwd,
                                                 flash_attention_fwd)
from repro_torch.kernels import lm_head as lmh
from repro_torch.kernels.rg_lru import _rg_lru_pallas_bwd, rg_lru_pallas
from repro_torch.launch import train as ttrain

GRAD_TOL = 1e-4  # float32, normwise per leaf
GRAD_TOL_BF16 = 2e-2  # bfloat16, normwise per leaf
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # elementwise
FLASH_BWD_NORM_TOL = 5e-3  # bf16, ||got - want|| / ||want|| per gradient
LSE_TOL = 1e-5

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


def _attn_inputs(seed, b, h, hkv, s, d, dtype, device, causal, window):
    """q, k, v, the kernel forward's o and lse, and an upstream gradient."""
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g, device=device).to(dtype)
                   for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d),
                                 (b, h, s, d)))
    o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                 return_lse=True)
    return q, k, v, o, lse, do


def _assert_grads_close(got, want, dtype, window=0):
    """Elementwise at the dtype's bar, and bf16 normwise per gradient.  At
    window 1 each row sees its own key alone, so dS = P (dP - delta) and
    with it dQ and dK are 0 up to rounding: a normwise error of rounding
    noise against rounding noise means nothing, so they are held to 1e-3
    absolute instead."""
    tol = FLASH_BWD_TOL[dtype]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol,
                                   msg=lambda m: f"{name}: {m}")
        if window == 1 and name != "dv":
            assert float(a.float().abs().max()) <= 1e-3, name
        elif dtype == torch.bfloat16:
            err = float(torch.linalg.vector_norm(a.float() - b.float())
                        / torch.linalg.vector_norm(b.float()))
            assert err <= FLASH_BWD_NORM_TOL, f"{name}: normwise {err}"


# every mask (causal, windows of 1, 63, 64, 300 and 2048, windows as long
# as S and longer, bidirectional with and without a window), groups of 1,
# 4, 6 and 10 q heads a kv head, head dims 64, 128 and 256 in both dtypes,
# S ragged against the 32-, 64- and 128-row tiles (37, 129, 130, 300, 333,
# 1001, 1016, 1200, 4095), the bf16 dK/dV pass's q heads split over blocks
# unevenly (10 over 3 and over 9 parts, at B = 2 and 3; 6 over 5: see
# test_flash_bwd_head_split_where_blocks_are_few), and the main paths'
# training shapes: Llama-3-8B (32 over 8, D=128), Qwen1.5-MoE (16 over
# 16), RecurrentGemma (10 over 1, D=256, window 2048: 10 over 5 parts),
# Whisper (12 over 12, D=64)
@pytest.mark.parametrize("b,h,hkv,s,d,dtype,causal,window", [
    (2, 4, 4, 256, 64, torch.float32, True, 0),
    (2, 4, 1, 256, 128, torch.float32, True, 0),
    (1, 10, 1, 300, 256, torch.float32, True, 64),
    (1, 2, 2, 200, 64, torch.float32, False, 50),
    (1, 4, 2, 130, 128, torch.float32, False, 0),
    (1, 4, 1, 37, 256, torch.float32, True, 0),
    (1, 4, 1, 37, 256, torch.bfloat16, True, 0),
    (1, 4, 2, 130, 128, torch.bfloat16, True, 0),
    (1, 2, 1, 300, 64, torch.bfloat16, True, 1),
    (1, 2, 1, 300, 256, torch.bfloat16, True, 63),
    (1, 2, 1, 256, 128, torch.bfloat16, True, 64),
    (1, 4, 2, 333, 256, torch.bfloat16, False, 100),
    (1, 4, 2, 300, 128, torch.bfloat16, False, 0),
    (1, 4, 4, 512, 256, torch.bfloat16, True, 0),
    (2, 4, 1, 1001, 64, torch.bfloat16, True, 0),
    (1, 10, 1, 1000, 256, torch.bfloat16, True, 300),
    (1, 12, 12, 1016, 64, torch.bfloat16, False, 0),
    (1, 12, 12, 1024, 64, torch.bfloat16, True, 0),
    (1, 16, 16, 1024, 128, torch.bfloat16, True, 0),
    (1, 32, 8, 4096, 128, torch.bfloat16, True, 0),
    (1, 10, 1, 4096, 256, torch.bfloat16, True, 2048),
    (1, 8, 2, 4095, 128, torch.bfloat16, True, 0),
    (1, 4, 1, 129, 256, torch.bfloat16, True, 0),
    (2, 6, 3, 129, 64, torch.bfloat16, False, 0),
    (3, 30, 3, 1200, 128, torch.bfloat16, True, 0),
    (1, 24, 4, 2048, 128, torch.bfloat16, True, 0),
    (1, 4, 1, 300, 128, torch.bfloat16, True, 1),
    (1, 10, 1, 500, 256, torch.bfloat16, True, 1),
    (1, 4, 2, 500, 64, torch.bfloat16, True, 500),
    (1, 10, 1, 700, 256, torch.bfloat16, True, 900),
    (2, 10, 1, 1000, 256, torch.bfloat16, True, 300),
])
def test_flash_bwd_kernel_matches_plain(cuda, b, h, hkv, s, d, dtype, causal,
                                        window):
    q, k, v, o, lse, do = _attn_inputs(b + h + s + d, b, h, hkv, s, d, dtype,
                                       cuda, causal, window)
    _, lse_want = ref.attention_ref(q, k, v, causal=causal, window=window,
                                    return_lse=True)
    torch.testing.assert_close(lse, lse_want, atol=LSE_TOL, rtol=LSE_TOL)
    before = _flash_attention_bwd.launches
    got = _flash_attention_bwd(q, k, v, o, lse, do, causal, window)
    torch.cuda.synchronize()
    assert _flash_attention_bwd.launches == before + 1
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window)
    _assert_grads_close(got, want, dtype, window)
    again = _flash_attention_bwd(q, k, v, o, lse, do, causal, window)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_flash_bwd_kernel_on_a_fresh_thread(cuda):
    """Launched from a thread that has made no CUDA runtime call yet, as
    autograd's device thread can be when this backward is the first node it
    runs."""
    args = _attn_inputs(5, 1, 4, 2, 300, 128, torch.bfloat16, cuda, True, 0)
    want = _flash_attention_bwd(*args, True, 0)
    torch.cuda.synchronize()
    out = {}

    def launch():
        try:
            out["got"] = _flash_attention_bwd(*args, True, 0)
        except RuntimeError as e:
            out["error"] = e

    thread = threading.Thread(target=launch)
    thread.start()
    thread.join(timeout=120)
    assert not thread.is_alive()
    assert "error" not in out, out.get("error")
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out["got"], want))


@pytest.mark.parametrize("h,hkv,s,d", [(16, 16, 1100, 128),
                                       (10, 1, 600, 256)])
def test_flash_bwd_kernel_twice_on_fresh_threads(cuda, h, hkv, s, d):
    """Two launches, each from a thread of its own that has made no CUDA
    runtime call yet (autograd's device thread's case), at D = 128 with no
    head split and at D = 256 with the group's 10 q heads split over 10
    blocks: the same bits as each other and as a launch from this
    thread."""
    args = _attn_inputs(d, 1, h, hkv, s, d, torch.bfloat16, cuda, True,
                        256)
    want = _flash_attention_bwd(*args, True, 256)
    torch.cuda.synchronize()
    outs = []

    def launch():
        try:
            outs.append(_flash_attention_bwd(*args, True, 256))
        except RuntimeError as e:
            outs.append(e)

    for _ in range(2):
        thread = threading.Thread(target=launch)
        thread.start()
        thread.join(timeout=120)
        assert not thread.is_alive()
    torch.cuda.synchronize()
    assert len(outs) == 2
    for got in outs:
        assert not isinstance(got, RuntimeError), got
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_flash_bwd_head_split_where_blocks_are_few(cuda):
    """The split the kernel's wrapper picks on this card for the uneven
    cases above, and none where the key tiles fill the card."""
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    if n_sm != 132:
        pytest.skip(f"the cases are sized for 132 SMs, this card has {n_sm}")
    assert _bwd_head_split(3, 30, 3, 1200, 128, True, n_sm) == 3
    assert _bwd_head_split(2, 10, 1, 1000, 256, True, n_sm) == 9
    assert _bwd_head_split(1, 24, 4, 2048, 128, True, n_sm) == 5
    assert _bwd_head_split(1, 10, 1, 4096, 256, True, n_sm) == 5
    assert _bwd_head_split(1, 32, 8, 4096, 128, True, n_sm) == 1


def test_flash_bwd_refuses_what_it_does_not_take(cuda):
    q, k, v, o, lse, do = _attn_inputs(6, 1, 2, 1, 64, 64, torch.float32,
                                       cuda, True, 0)
    with pytest.raises(ValueError, match="dtype"):
        _flash_attention_bwd(*(t.half() for t in (q, k, v, o)), lse,
                             do.half())
    with pytest.raises(ValueError, match="head dim"):
        _flash_attention_bwd(q[..., :32], k[..., :32], v[..., :32],
                             o[..., :32], lse, do[..., :32])
    with pytest.raises(ValueError, match="lse"):
        _flash_attention_bwd(q, k, v, o, lse.double(), do)
    strided = do.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="not contiguous"):
        _flash_attention_bwd(q, k, v, o, lse, strided)
    before = _flash_attention_bwd.launches
    got = ops.flash_attention_bwd(q, k, v, o, lse, strided)  # copied
    assert _flash_attention_bwd.launches == before + 1
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
    _assert_grads_close(got, want, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_op_is_differentiable_through_the_kernels(cuda, dtype):
    """``ops.flash_attention`` on the card: the forward kernel with lse, the
    backward kernel, and the gradient against autograd through
    ``attention_ref`` (the recompute the kernel replaces)."""
    q, k, v, _, _, do = _attn_inputs(7, 2, 8, 2, 333, 128, dtype, cuda, True,
                                     100)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    f0, b0 = flash_attention_fwd.launches, _flash_attention_bwd.launches
    out = ops.flash_attention(*leaves, True, 100)
    got = torch.autograd.grad(out, leaves, do)
    assert (flash_attention_fwd.launches, _flash_attention_bwd.launches) == \
        (f0 + 1, b0 + 1)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention_ref(*plain, causal=True,
                                                 window=100), plain, do)
    _assert_grads_close(got, want, dtype)
    with torch.no_grad():  # no gradient wanted: the serving launch, no lse
        ops.flash_attention(q, k, v, True, 100)


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
              _rg_lru_pallas_bwd.launches, _flash_attention_bwd.launches)
    loss, got = _grads(params, cfg,
                       {k: v.to(device) for k, v in batch.items()})
    after = (flash_attention_fwd.launches, rg_lru_pallas.launches,
             _rg_lru_pallas_bwd.launches, _flash_attention_bwd.launches)
    # remat: forward and recompute of 1 attention and 2 RG-LRU sublayers;
    # one backward each
    assert [b - a for a, b in zip(before, after)] == [2, 4, 2, 1]
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


WRAPPERS = (flash_attention_fwd, _flash_attention_bwd, rg_lru_pallas,
            _rg_lru_pallas_bwd)
DOTS_ARCHS = {"griffin": "recurrentgemma-2b", "dense": "llama3-8b",
              "moe": "qwen2-moe-a2.7b"}
MOE_DOTS_TOL = 1e-6  # normwise per leaf: the dispatch's accumulating put


def _policy_run(cfg, policy, params, batch):
    """Loss, per-leaf gradients and kernel launches of one backward under
    ``policy``, then one two-micro-batch train step from ``params``: its
    loss and new parameters."""
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.steps import TrainState, build_train_step
    cfg = dataclasses.replace(cfg, remat_policy=policy)
    before = [w.launches for w in WRAPPERS]
    loss, grads = _grads(params, cfg, batch)
    torch.cuda.synchronize()
    launches = [w.launches - b for w, b in zip(WRAPPERS, before)]
    opt = AdamWConfig(lr=1e-3, warmup_steps=0)
    params = _tree.tree_map(torch.clone, params)  # the step updates in place
    state = TrainState(params, adamw_init(opt, params),
                       torch.zeros((), dtype=torch.int32,
                                   device=batch["tokens"].device))
    state, m = build_train_step(cfg, opt, n_micro=2)(state, batch)
    return (loss, grads, launches, m["loss"], _tree.leaves(state.params))


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm((a - b).float())
                 / torch.linalg.vector_norm(b.float()).clamp_min(1e-30))


@pytest.mark.parametrize("family", sorted(DOTS_ARCHS))
def test_dots_step_equals_nothing_on_the_card(cuda, family):
    """``remat_policy="dots"`` on the card: the same kernel launches as
    ``"nothing"`` (the forward's, the recompute's and the backward's), the
    gradients and one train step bit for bit (the MoE's within 1e-6
    normwise a leaf: the dispatch's accumulating ``index_put``)."""
    cfg = dataclasses.replace(configs.get_smoke_config(DOTS_ARCHS[family]),
                              d_head=64)
    params = models.init_model(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    tokens = torch.randint(1, cfg.vocab, (4, 256), generator=g, device=cuda)
    batch = {"tokens": tokens, "labels": tokens}
    want = _policy_run(cfg, "nothing", params, batch)
    got = _policy_run(cfg, "dots", params, batch)
    assert got[2] == want[2]
    assert got[2][0] > 0 and (got[2][2] > 0) == (family == "griffin")
    pairs = list(zip([torch.tensor(got[0]), got[3], *got[1], *got[4]],
                     [torch.tensor(want[0]), want[3], *want[1], *want[4]]))
    for a, b in pairs:
        if family == "moe":
            assert _rel(a, b) <= MOE_DOTS_TOL
        else:
            assert torch.equal(a, b)


def test_sharded_dots_step_on_one_rank_equals_the_plain_dots_step(cuda):
    """``tests/test_torch_sharding_cuda.py``'s 1 x 1 NCCL mesh step under
    ``remat_policy="dots"``: the saved products are DTensors, the step bit
    for bit with the plain dots step, flash launched as often."""
    from test_torch_sharding_cuda import _step
    cfg = dataclasses.replace(configs.get_smoke_config("llama3_8b"),
                              d_head=64, remat_policy="dots")
    loss0, p0, n0 = _step(cfg, cuda, sharded=False)
    loss1, p1, n1 = _step(cfg, cuda, sharded=True)
    assert n0 == n1 == 2 * cfg.n_layers * 2  # 2 micro-batches, + recompute
    assert torch.equal(loss0, loss1)
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)


def test_flash_bwd_from_autograd_under_dots_on_a_fresh_thread(cuda):
    """``test_flash_bwd_kernel_on_a_fresh_thread`` through the model under
    ``remat_policy="dots"``: a forward and backward from a thread that has
    made no CUDA runtime call yet, whose recompute and attention backward
    kernels run on autograd's device thread, against the same gradients
    under ``"nothing"`` from this thread, bit for bit."""
    cfg = dataclasses.replace(configs.get_smoke_config("qwen2-moe-a2.7b"),
                              d_head=64)
    params = models.init_model(
        cfg, torch.Generator(device=cuda).manual_seed(2), cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    tokens = torch.randint(1, cfg.vocab, (2, 300), generator=g, device=cuda)
    batch = {"tokens": tokens, "labels": tokens}
    _, want = _grads(params, dataclasses.replace(cfg, remat_policy="nothing"),
                     batch)
    torch.cuda.synchronize()
    before = _flash_attention_bwd.launches
    out = {}

    def run():
        try:
            out["got"] = _grads(params, dataclasses.replace(
                cfg, remat_policy="dots"), batch)[1]
        except RuntimeError as e:
            out["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join(timeout=120)
    assert not thread.is_alive()
    assert "error" not in out, out.get("error")
    torch.cuda.synchronize()
    assert _flash_attention_bwd.launches - before == cfg.n_layers
    for a, b in zip(out["got"], want):
        assert _rel(a, b) <= MOE_DOTS_TOL


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


# the LM head's products: ragged T, d and V (T = 1 as a decode step, an
# odd V as Whisper's 51,865 rows), then the cells' micro-batches
# (InternLM2-20B, then Mistral-7B: T x d x V)
LM_HEAD_SHAPES = [(3, 64, 1000), (1001, 64, 1000), (1001, 128, 1000),
                  (1, 64, 999), (130, 64, 51865), (4096, 6144, 92544),
                  (4096, 4096, 32000)]
LM_HEAD_ERR_RATIO = 2.0  # of cuBLAS float32's largest error
# and of its count of gradient elements off bf16(the float64 product),
# plus a few elements where both counts are near zero
LM_HEAD_OFF_SLACK = 8


def _lm_head_operands(t, d, v, device):
    """x as a norm's bf16 output, the head at the cells' init (std 0.02),
    dlogits as the loss's: (softmax - onehot) / T, float32."""
    g = torch.Generator(device=device).manual_seed(t + d + v)
    x = torch.randn((t, d), generator=g, device=device).to(torch.bfloat16)
    w = (torch.randn((d, v), generator=g, device=device) * 0.02).to(
        torch.bfloat16)
    p = torch.softmax(torch.randn((t, v), generator=g, device=device) * 2,
                      dim=-1)
    labels = torch.randint(0, v, (t,), generator=g, device=device)
    p[torch.arange(t, device=device), labels] -= 1.0
    return x, w, p / t


def _max_err(got, want64) -> float:
    return float((got.double() - want64).abs().max())


@pytest.mark.parametrize("t,d,v", LM_HEAD_SHAPES)
def test_lm_head_kernels_lose_no_precision(cuda, t, d, v):
    x, w, dl = _lm_head_operands(t, d, v, cuda)
    before = [f.launches for f in (lmh._lm_head_fwd, lmh._lm_head_dx,
                                   lmh._lm_head_dw)]
    cases = {
        "forward": (lambda: lmh._lm_head_fwd(x, w),
                    lambda: ref.lm_head_fwd_ref(x, w),
                    lambda: x.double() @ w.double()),
        "dx": (lambda: lmh._lm_head_dx(dl, w),
               lambda: ref.lm_head_dx_ref(dl, w),
               lambda: dl.double() @ w.double().t()),
        "dw": (lambda: lmh._lm_head_dw(x, dl),
               lambda: ref.lm_head_dw_ref(x, dl),
               lambda: x.double().t() @ dl.double()),
    }
    errs, flips = {}, {}
    for name, (kernel, cublas, exact) in cases.items():
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"{name}: two calls differ"
        want64 = exact()
        plain = cublas()
        errs[name] = (_max_err(got, want64), _max_err(plain, want64))
        if name != "forward":  # elements off bf16(the float64 product)
            want16 = want64.to(torch.bfloat16)
            flips[name] = (int((got != want16).sum()),
                           int((plain != want16).sum()))
            del want16
        del got, again, plain, want64
        torch.cuda.empty_cache()
    assert [f.launches - b for f, b in zip(
        (lmh._lm_head_fwd, lmh._lm_head_dx, lmh._lm_head_dw), before)] == \
        [2, 2, 2]
    print(f"lm_head ({t}, {d}, {v}) largest error, kernel / cuBLAS "
          f"float32:", {k: f"{a:.3g} / {b:.3g}" for k, (a, b) in
                        errs.items()},
          "elements off bf16(float64), kernel / cuBLAS float32:", flips)
    for name, (kernel_err, cublas_err) in errs.items():
        assert kernel_err <= LM_HEAD_ERR_RATIO * cublas_err, (
            f"{name}: {kernel_err} against cuBLAS float32's {cublas_err}")
    # the rounding to bf16 hides a coarser float32 sum from the largest
    # error, not from the count of elements it rounds the other way
    for name, (kernel_off, cublas_off) in flips.items():
        assert kernel_off <= (LM_HEAD_ERR_RATIO * cublas_off
                              + LM_HEAD_OFF_SLACK), (
            f"{name}: {kernel_off} elements off bf16(float64) against "
            f"cuBLAS float32's {cublas_off}")


@pytest.mark.parametrize("t,d,v,scale", [(1024, 1024, 1024, -40),
                                         (1000, 136, 1003, -10)])
def test_lm_head_backward_split_is_exact(cuda, t, d, v, scale):
    """dX and dW on operands whose float32 sums are exact in any order
    (``test_torch_lm_head.exact_operands``): bit for bit with bf16(the
    float64 product), as cuBLAS float32's; a split that dropped its third
    piece differed in 2.3 elements in a thousand of dX, one that kept only
    the first in 41% (builds of those on an H100)."""
    from test_torch_lm_head import exact_operands
    x, w, dl = exact_operands(t, d, v, seed=t + d, scale=scale,
                              device=cuda)
    for name, got, plain, exact in (
            ("dx", lmh._lm_head_dx(dl, w), ref.lm_head_dx_ref(dl, w),
             dl.double() @ w.double().t()),
            ("dw", lmh._lm_head_dw(x, dl), ref.lm_head_dw_ref(x, dl),
             x.double().t() @ dl.double())):
        want = exact.to(torch.bfloat16)
        assert torch.equal(plain, want), f"{name}: cuBLAS float32"
        off = int((got != want).sum())
        assert off == 0, f"{name}: {off} of {want.numel()} elements differ"


def test_lm_head_kernels_on_a_fresh_thread(cuda):
    """The backward's products launched from a thread that has made no
    CUDA runtime call yet, as autograd's device thread can be."""
    x, w, dl = _lm_head_operands(300, 64, 1000, cuda)
    want = (lmh._lm_head_dx(dl, w), lmh._lm_head_dw(x, dl))
    torch.cuda.synchronize()
    out = {}

    def launch():
        try:
            out["got"] = (lmh._lm_head_dx(dl, w), lmh._lm_head_dw(x, dl))
        except RuntimeError as e:
            out["error"] = e

    thread = threading.Thread(target=launch)
    thread.start()
    thread.join(timeout=120)
    assert not thread.is_alive()
    assert "error" not in out, out.get("error")
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out["got"], want))


def test_lm_head_refuses_what_it_does_not_take(cuda):
    x, w, dl = _lm_head_operands(8, 64, 100, cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        lmh._lm_head_fwd(x[:, :60], w[:60])
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        lmh._lm_head_fwd(x.float(), w)
    with pytest.raises(ValueError, match="expected torch.float32"):
        lmh._lm_head_dx(dl.to(torch.bfloat16), w)


def test_one_loss_backward_launches_the_head_kernels_once_each(cuda,
                                                               monkeypatch):
    """``loss_fn`` on bf16 parameters on the card: 1 forward launch of the
    head, 2 in its backward, and the head's gradient is autograd's through
    the float32 expression's within bf16 rounding."""
    cfg = dataclasses.replace(configs.get_smoke_config("llama3-8b"),
                              d_head=64)
    assert cfg.param_dtype == torch.bfloat16
    assert cfg.logit_dtype == torch.float32
    params = models.init_model(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 65), generator=g, device=cuda)
    batch = {"tokens": tokens[:, :-1].contiguous(),
             "labels": tokens[:, 1:].contiguous()}
    entries = (lmh._lm_head_fwd, lmh._lm_head_dx, lmh._lm_head_dw)
    before = [f.launches for f in entries]
    for leaf in _tree.leaves(params):
        leaf.requires_grad_()
    head = params["head"]
    loss, _ = models.loss_fn(params, cfg, batch)
    fwd = [f.launches - b for f, b in zip(entries, before)]
    loss.backward()
    torch.cuda.synchronize()
    total = [f.launches - b for f, b in zip(entries, before)]
    assert fwd == [1, 0, 0] and total == [1, 1, 1]
    got = head.grad
    head.grad = None
    # the float32 expression in the kernels' place
    monkeypatch.setattr(ops, "lm_head", lambda x, w: x.float() @ w.float())
    loss_old, _ = models.loss_fn(params, cfg, batch)
    loss_old.backward()
    assert abs(float(loss.detach()) - float(loss_old.detach())) <= \
        1e-5 * abs(float(loss_old.detach()))
    assert _rel(got, head.grad) <= 1e-2
