"""Mellum2-12B-A2.5B's new parts on the card: the held experts' grouped
products (``torch._grouped_mm`` for bfloat16 CUDA operands, in
``models/moe.py``'s ``_HeldExperts``) against the same function by one
float32 product a group, and the smoke configuration on the card (the
flash kernel at each layer's window, YaRN on the full layer) against the
same weights on the card's host.

Every test here is marked ``cuda`` and skips (with its reason) where no
CUDA device is present.  The file imports only torch and the port, so it
runs on a GPU machine that has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mellum2_cuda.py

Tolerances: bfloat16 grouped products against float32 ones are held at
2e-2 normwise (operands and results rounded to bf16, 2^-9 each, over
sums of hundreds of terms: the products read ~4e-3 at the cell's
shapes); the float32 smoke configuration at 1e-4 normwise, as the moe
family's other card tests (the float32 flash kernel against the plain
chunked attention).
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch import models
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import moe
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import build_train_step
from repro_torch.runtime.steps import init_train_state

BF16_NORM_TOL = 2e-2
F32_NORM_TOL = 1e-4

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch._grouped_mm and the flash "
                    "kernel have no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _normwise(got, want) -> float:
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).norm() / want.norm())


def _grouped_case(dev, sizes, d=256, f=128, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    n = len(sizes)
    padded = [max(-(-s // moe.GROUP_ROWS), 1) * moe.GROUP_ROWS for s in sizes]
    ends = tuple(sum(padded[:i + 1]) for i in range(n))
    x = torch.randn((ends[-1], d), generator=g, device=dev)
    ws = [torch.randn(s, generator=g, device=dev) * 0.05
          for s in ((n, d, f), (n, d, f), (n, f, d))]
    d_out = torch.randn((ends[-1], d), generator=g, device=dev)
    offs = torch.tensor(ends, dtype=torch.int32, device=dev)

    def run(dtype):
        xx = x.to(dtype).requires_grad_()
        w = [t.to(dtype).requires_grad_() for t in ws]
        out = moe._HeldExperts.apply(xx, offs, *w)
        out.backward(d_out.to(dtype))
        return [out.detach(), xx.grad] + [t.grad for t in w]

    return run(torch.bfloat16), run(torch.float32)


@pytest.mark.parametrize("sizes", [[300, 17, 0, 512], [2048] * 8])
def test_the_grouped_products_match_float32_ones(cuda, sizes):
    got, want = _grouped_case(cuda, sizes)
    for name, a, b in zip(("out", "dx", "d_gate", "d_up", "d_down"), got,
                          want):
        assert a.dtype == torch.bfloat16, name
        assert _normwise(a, b) <= BF16_NORM_TOL, name


def test_the_held_layer_in_bf16_is_the_float32_one(cuda):
    """The whole layer on the card in bfloat16 (the buffer's rows past the
    last group are left unwritten by the grouped products and out of the
    sum) against the same layer in float32 on the card's host: output and
    every gradient."""
    cfg = dataclasses.replace(configs.get_smoke_config("mellum2-12b-a2.5b"),
                              d_model=256, moe_d_ff=128)
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, 128, 256), generator=g)
    p = {"router": torch.randn((256, 16), generator=g) * 0.1,
         "w_gate": torch.randn((4, 256, 128), generator=g) * 0.05,
         "w_up": torch.randn((4, 256, 128), generator=g) * 0.05,
         "w_down": torch.randn((4, 128, 256), generator=g) * 0.05}
    dy = torch.randn((2, 128, 256), generator=g)

    def run(dev, dtype):
        xx = x.to(dev, dtype).requires_grad_()
        pp = {k: v.to(dev, torch.float32 if k == "router" else dtype)
              .requires_grad_() for k, v in p.items()}
        y, aux, c = moe.held_experts_block(pp, cfg, xx)
        (y.float() * dy.to(dev)).sum().backward()
        return [y, xx.grad] + [pp[k].grad for k in p], c

    got, c_d = run(cuda, torch.bfloat16)
    want, c_h = run(torch.device("cpu"), torch.float32)
    assert float(c_d["moe_held_rows"]) == float(c_h["moe_held_rows"])
    for name, a, b in zip(["y", "dx"] + list(p), got, want):
        assert torch.isfinite(a).all(), name
        assert _normwise(a, b) <= BF16_NORM_TOL, name


def _smoke_f32(**kw):
    """The smoke configuration at a head dim the flash kernel takes."""
    return dataclasses.replace(configs.get_smoke_config("mellum2-12b-a2.5b"),
                               d_head=64, dtype=torch.float32,
                               param_dtype=torch.float32, **kw)


def test_the_smoke_config_on_the_card_is_its_hosts(cuda):
    cfg = _smoke_f32()
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=g)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}

    def run(dev):
        p = models.init_model(cfg, torch.Generator().manual_seed(0), dev)
        leaves = [t.requires_grad_() for t in _leaves(p)]
        loss, metrics = models.loss_fn(
            p, cfg, {k: v.to(dev) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), metrics, grads

    before = fa.flash_attention_fwd.launches
    loss_d, met_d, grads_d = run(cuda)
    # a launch a layer in the forward and one in remat's recompute
    assert fa.flash_attention_fwd.launches - before == 2 * cfg.n_layers
    loss_h, met_h, grads_h = run(torch.device("cpu"))
    assert _normwise(loss_d, loss_h) <= F32_NORM_TOL
    assert float(met_d["moe_held_rows"]) == float(met_h["moe_held_rows"])
    for gd, gh in zip(grads_d, grads_h):
        assert _normwise(gd, gh) <= F32_NORM_TOL


def _leaves(tree):
    out = []
    for v in tree.values():
        out += _leaves(v) if isinstance(v, dict) else [v]
    return out


def test_a_bf16_train_step_runs_the_windows_and_counts_every_row(
        cuda, monkeypatch):
    """Two micro-batches in bfloat16: the flash kernel at windows 8 and 0,
    its backward once a layer a micro-batch, nothing dropped."""
    from repro_torch.kernels import ops
    windows, real = [], ops.flash_attention

    def spy(q, k, v, causal=True, window=0):
        windows.append(window)
        return real(q, k, v, causal, window)

    monkeypatch.setattr(ops, "flash_attention", spy)
    cfg = dataclasses.replace(configs.get_smoke_config("mellum2-12b-a2.5b"),
                              d_head=64)
    opt = AdamWConfig()
    state = init_train_state(cfg, opt, torch.Generator().manual_seed(2),
                             cuda)
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (4, 64), generator=g)
    batch = {"tokens": tokens.to(cuda),
             "labels": torch.roll(tokens, -1, 1).to(cuda)}
    step = build_train_step(cfg, opt, 2)
    fwd = fa.flash_attention_fwd.launches
    bwd = fa._flash_attention_bwd.launches
    state, metrics = step(state, batch)
    assert fa.flash_attention_fwd.launches - fwd == 2 * 2 * cfg.n_layers
    assert fa._flash_attention_bwd.launches - bwd == 2 * cfg.n_layers
    # 2 micro-batches, each layer in the forward and in remat's recompute
    assert sorted(windows) == [0] * 4 + [8] * 12
    assert torch.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
    # 4 x 64 tokens x top-4 over 16 experts: about a quarter land on the
    # 4 held ones in each of the 4 layers
    rows = float(metrics["moe_held_rows"])
    assert 0 < rows <= 4 * 64 * 4 * cfg.n_layers
    assert float(metrics["moe_held_load_max"]) >= 1.0
