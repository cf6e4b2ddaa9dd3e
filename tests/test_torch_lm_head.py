"""The LM head's kernels' arithmetic and dispatch, on the CPU.

The kernels (``kernels/csrc/lm_head.cu``) run only on the card; here their
plain versions and the numbers behind them: the three-way bfloat16 split of
a float32 value is exact (summed in float64) for 2^-100 <= |a| < 2^127
(above, hi rounds to infinity; the head's gradients are below 1), across
the softmax gradient's range; the plain forward is the model's old
expression bit for bit; ``kernels.ops.lm_head``'s
gradients on the CPU equal autograd's through the old expression bit for
bit, as bf16; ``models.model._logits`` keeps the old expression on the
CPU and for float32 parameters; its product on DTensors
(``_head_product``, each rank's block through ``ops.lm_head``) is the
plain one's on one rank and over four; the card's exact-split operands
catch a split that drops a piece; and nothing launches on the CPU.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch import models
from repro_torch.kernels import lm_head as lmh
from repro_torch.kernels import ops, ref
from repro_torch.models import model as tmodel

ARCH = "llama3_8b"
ENTRIES = (lmh._lm_head_fwd, lmh._lm_head_dx, lmh._lm_head_dw)


def _pieces_sum(a: torch.Tensor) -> torch.Tensor:
    return sum(p.double() for p in ref.bf16x3_split_ref(a))


def _split_values(kind: str, n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if kind == "normal":
        a = rng.standard_normal(n)
    elif kind == "wide":  # |a| from 2^-100 to 2^100, both signs
        a = rng.choice([-1.0, 1.0], n) * 2.0 ** rng.uniform(-100, 100, n)
    elif kind == "softmax_grad":  # p or p - 1 over a large vocabulary
        p = 10.0 ** rng.uniform(-13, -4, n)
        a = np.where(rng.random(n) < 0.01, p - 1.0, p) / 4096.0
    else:  # float32s of random bits in the range
        bits = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
        a = bits.view(np.float32)
        with np.errstate(invalid="ignore"):
            a = a[(np.abs(a) >= 2.0 ** -100) & (np.abs(a) < 2.0 ** 127)]
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


@pytest.mark.parametrize("kind", ["normal", "wide", "softmax_grad", "bits"])
def test_the_three_way_split_is_exact(kind):
    a = _split_values(kind, 1 << 18, seed=len(kind))
    hi, mid, lo = ref.bf16x3_split_ref(a)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(_pieces_sum(a), a.double())


def test_the_split_keeps_more_than_two_pieces_do():
    # the two-piece split that the three-way one replaces loses bits
    a = _split_values("normal", 1 << 14, seed=1)
    hi, mid, _ = ref.bf16x3_split_ref(a)
    assert not torch.equal(hi.double() + mid.double(), a.double())


def test_the_split_first_fails_below_bfloat16s_normal_range():
    a = torch.tensor([1.2345678e-30, 1.2345678e-36], dtype=torch.float32)
    got = _pieces_sum(a)
    assert got[0] == a[0].double() and got[1] != a[1].double()


def _operands(t, d, v, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((t, d), generator=g).to(torch.bfloat16)
    w = (torch.randn((d, v), generator=g) * d ** -0.5).to(torch.bfloat16)
    dl = torch.softmax(torch.randn((t, v), generator=g), -1) / t
    return x, w, dl


SHAPES = [(3, 64, 1000), (17, 32, 51), (8, 16, 8)]


@pytest.mark.parametrize("t,d,v", SHAPES)
def test_the_plain_forward_is_the_old_expression(t, d, v):
    x, w, _ = _operands(t, d, v, seed=t)
    assert torch.equal(lmh._lm_head_fwd(x, w), x.float() @ w.float())


@pytest.mark.parametrize("t,d,v", SHAPES)
def test_the_functions_gradients_are_the_old_autograds(t, d, v):
    x, w, dl = _operands(t, d, v, seed=t + 1)
    x3 = x.view(1, t, d)
    got_x, got_w = (a.clone().requires_grad_() for a in (x3, w))
    want_x, want_w = (a.clone().requires_grad_() for a in (x3, w))
    out = ops.lm_head(got_x, got_w)
    old = want_x.to(torch.float32) @ want_w.to(torch.float32)
    assert out.dtype == torch.float32 and torch.equal(out, old)
    out.backward(dl.view(1, t, v))
    old.backward(dl.view(1, t, v))
    assert got_x.grad.dtype == got_w.grad.dtype == torch.bfloat16
    assert torch.equal(got_x.grad, want_x.grad)
    assert torch.equal(got_w.grad, want_w.grad)


def test_the_function_computes_only_the_gradients_asked_for():
    x, w, dl = _operands(5, 16, 40, seed=3)
    w = w.requires_grad_()
    ops.lm_head(x, w).backward(dl)
    assert torch.equal(w.grad, ref.lm_head_dw_ref(x, dl))


def _cfg(**kw):
    kw = dict(dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                   logit_dtype=torch.float32), **kw)
    return dataclasses.replace(configs.get_smoke_config(ARCH), **kw)


def _batch(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (2, 9), generator=g)
    return {"tokens": tokens[:, :-1].contiguous(),
            "labels": tokens[:, 1:].contiguous()}


@pytest.fixture
def spy(monkeypatch):
    """Counts the calls of the head's differentiable entry."""
    calls = []
    real = ops.lm_head

    def counted(x, w):
        calls.append((x.dtype, w.dtype))
        return real(x, w)

    monkeypatch.setattr(ops, "lm_head", counted)
    return calls


def _logits_and_old(cfg, params):
    x = torch.randn((2, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(5)).to(cfg.dtype)
    got = tmodel._logits(params, cfg, x)
    xn = models.layers.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    head = params["head"]
    return got, xn.to(cfg.logit_dtype) @ head.to(cfg.logit_dtype)


def test_logits_keep_the_old_expression_on_the_cpu(spy):
    cfg = _cfg()
    params = models.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    got, old = _logits_and_old(cfg, params)
    assert spy == [] and torch.equal(got, old)


def test_logits_keep_the_old_expression_for_float32_parameters(spy):
    cfg = _cfg(dtype=torch.float32, param_dtype=torch.float32)
    params = models.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    got, old = _logits_and_old(cfg, params)
    assert spy == [] and torch.equal(got, old)


def _head_case(x, w, g, px, ph, mesh):
    """``_head_product`` of x and w distributed as ``px`` and ``ph`` on
    ``mesh``, backward from g: the logits and both gradients, whole."""
    from torch.distributed.tensor import distribute_tensor
    xd = distribute_tensor(x, mesh, px).requires_grad_()
    wd = distribute_tensor(w, mesh, ph).requires_grad_()
    out = tmodel._head_product(xd, wd)
    out.backward(distribute_tensor(g, mesh, out.placements))
    return (out.full_tensor().detach(), xd.grad.full_tensor(),
            wd.grad.full_tensor())


def _head_plain(x, w, g):
    x, w = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = ops.lm_head(x, w)
    out.backward(g)
    return out.detach(), x.grad, w.grad


def _head_operands(b, s, d, v, seed):
    x, w, _ = _operands(b * s, d, v, seed)
    g = torch.randn((b, s, v), generator=torch.Generator().manual_seed(seed))
    return x.view(b, s, d), w, g


def test_the_heads_product_on_a_one_rank_mesh_is_the_plain_one(spy):
    """``_head_product`` on DTensors: each rank's block through
    ``ops.lm_head`` (its plain versions on the CPU), on a 1 x 1 mesh bit
    for bit with the plain call, the logits and both gradients."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, 1, device="cpu")
    x, w, g = _head_operands(2, 8, 64, 48, seed=7)
    want = _head_plain(x, w, g)
    for px, ph in (([Shard(0), Replicate()], [Replicate(), Shard(1)]),
                   ([Replicate(), Replicate()], [Replicate(), Replicate()])):
        got = _head_case(x, w, g, px, ph, mesh)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert len(spy) == 3


# rows of x and the head's columns split, gathered or both over a 2 x 2
# ("data", "model") mesh of 4 gloo ranks
HEAD_LAYOUTS = [("rows_vocab", ("S0", "R"), ("R", "S1")),
                ("rows_seq", ("S0", "S1"), ("R", "R")),
                ("d_split", ("R", "S2"), ("S1", "S0")),
                ("same_dim", ("S0", "R"), ("S1", "S1"))]
HEAD_WORLD = 4
HEAD_JOIN_S = 60


def _placement(code):
    from torch.distributed.tensor import Replicate, Shard
    return Replicate() if code == "R" else Shard(int(code[1:]))


def _head_rank(rank, tmp):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=HEAD_WORLD)
    try:
        mesh = make_host_mesh(2, 2, device="cpu")
        x, w, g = _head_operands(4, 6, 32, 24, seed=11)
        out = {}
        for name, px, ph in HEAD_LAYOUTS:
            got = _head_case(x, w, g, [_placement(c) for c in px],
                             [_placement(c) for c in ph], mesh)
            for key, t in zip(("logits", "dx", "dw"), got):
                out[f"{name}:{key}"] = t.float().numpy()
        if rank == 0:
            np.savez(f"{tmp}/out.npz", **out)
    finally:
        dist.destroy_process_group()


def test_the_heads_product_over_four_ranks_is_the_plain_one(tmp_path):
    """``_head_product`` over a 2 x 2 mesh of 4 gloo ranks, for x's rows
    and the head's vocab split, x's sequence split, a split d gathered,
    and both split over one mesh dim: the logits as the plain call's
    (float32 products of the same values), both bf16 gradients within 2^-7
    normwise (each rank's partial sum is rounded to bf16 before the ranks
    add them; a partial sum left unreduced, or one counted twice, reads
    ~0.5 or more)."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_head_rank, args=(str(tmp_path),),
                             nprocs=HEAD_WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + HEAD_JOIN_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            assert time.monotonic() < deadline, "ranks still running"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    got = dict(np.load(tmp_path / "out.npz"))
    x, w, g = _head_operands(4, 6, 32, 24, seed=11)
    want = [t.float().numpy() for t in _head_plain(x, w, g)]
    for name, _, _ in HEAD_LAYOUTS:
        np.testing.assert_allclose(got[f"{name}:logits"], want[0],
                                   rtol=1e-6, atol=1e-6, err_msg=name)
        for key, ref_t in zip(("dx", "dw"), want[1:]):
            err = np.linalg.norm(got[f"{name}:{key}"] - ref_t) / \
                np.linalg.norm(ref_t)
            assert err <= 2.0 ** -7, (name, key, err)


def exact_operands(t, d, v, seed, scale=-40, device="cpu"):
    """Operands on which every float32 sum of the backward's products is
    exact, so that a kernel that keeps all three split pieces returns
    bf16(the float64 product) bit for bit in any order of summation: x and
    the head hold -1, 0 and 1; dlogits holds at most 8 values in a row and
    in a column (t <= v), each an integer of 21 significant bits times
    2^scale (so that its split needs all three pieces), and no sum of 8 of
    them passes float32's 24 bits."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-1, 2, (t, d)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-1, 2, (d, v)).astype(np.float32))
    dl = np.zeros((t, v), dtype=np.float32)
    for _ in range(8):
        dl[np.arange(t), rng.permutation(v)[:t]] = np.ldexp(
            rng.choice([-1.0, 1.0], t) * rng.integers(2 ** 20, 2 ** 21, t),
            scale)
    return (x.to(torch.bfloat16).to(device), w.to(torch.bfloat16).to(device),
            torch.from_numpy(dl).to(device))


def _split_products(dl, w, x, pieces):
    """dX and dW from the first ``pieces`` of dlogits' split, summed in
    float64 and rounded to bf16."""
    part = sum(p.double() for p in ref.bf16x3_split_ref(dl)[:pieces])
    return ((part @ w.double().t()).to(torch.bfloat16),
            (x.double().t() @ part).to(torch.bfloat16))


def test_the_exact_operands_catch_a_split_that_drops_a_piece():
    """The card's exact-split test's operands: all three pieces give
    bf16(the float64 product) bit for bit, as the plain versions do; two
    pieces, or one, differ in some elements of both gradients."""
    x, w, dl = exact_operands(512, 256, 600, seed=2)
    want = _split_products(dl, w, x, 3)
    assert torch.equal(want[0], ref.lm_head_dx_ref(dl, w))
    assert torch.equal(want[1], ref.lm_head_dw_ref(x, dl))
    for pieces in (1, 2):
        for a, b in zip(_split_products(dl, w, x, pieces), want):
            assert int((a != b).sum()) >= 10, pieces


def test_nothing_launches_on_the_cpu():
    cfg = _cfg()
    params = models.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    head = params["head"].requires_grad_()
    before = [f.launches for f in ENTRIES]
    loss, _ = models.loss_fn(params, cfg, _batch(cfg))
    loss.backward()
    assert head.grad is not None
    assert [f.launches for f in ENTRIES] == before == [0, 0, 0]
