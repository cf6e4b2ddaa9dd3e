"""The family contract (``perfbench/families/__init__.py``) through a family
defined here and registered under ``perfbench.families``, as a later one
is added by a file of its own: an auxiliary loss with a weight, a float32
leaf beside bfloat16 ones, routed experts counted at top-k, and windowed
and full attention layers mixed.  And ``dense`` through the widened
contract: the reference's readings and a step's FLOPs as they were before
it, from frozen copies of the old walk and count."""
import sys
import types

import numpy as np
import pytest
import torch

from perfbench import inputs, reference, spec, train_cell, workcount
from perfbench.families import dense
from conftest import tiny

TOY = "toy_moe"
TOY_MODEL = dict(name="toy", family=TOY, n_layers=2, d_model=16, n_heads=1,
                 vocab=64, n_experts=4, n_experts_total=8, top_k=2, window=3,
                 norm_eps=1e-5, param_dtype="bfloat16")
TOY_TRAFFIC = dict(kind="train", seq=12, seqs_per_step=4, n_micro=2,
                   optimizer=dict(lr=3e-3, b1=0.9, b2=0.95, eps=1e-8,
                                  weight_decay=0.1, grad_clip=1.0,
                                  warmup_steps=0, total_steps=100,
                                  min_lr_frac=0.1))
ROUTED = ("layers.moe.w",)


def _toy_family(aux_weight: float, with_aux: bool = True):
    """A family module: each layer a one-head attention over the stream
    (windowed in the even layers, full in the odd ones), then a soft
    mixture over the experts held here of the float32 router's
    probabilities over all the experts, with a load-balance-like term."""
    fam = types.ModuleType(f"perfbench.families.{TOY}")
    fam.AUX_WEIGHT = aux_weight

    def leaf_specs(model):
        n, d, v = model["n_layers"], model["d_model"], model["vocab"]
        e, held = model["n_experts_total"], model["n_experts"]
        return [("embed", (v, d), 0.02), ("head", (d, v), 0.02),
                ("ln_f.scale", (d,), 0.0),
                ("layers.router", (n, d, e), 0.3, "float32"),
                ("layers.moe.w", (n, held, d, d), 0.1)]

    def attention_windows(model):
        return [0 if i % 2 else model["window"]
                for i in range(model["n_layers"])]

    def token_weights(model):
        return workcount.token_weights(leaf_specs(model), ROUTED,
                                       model["top_k"],
                                       model["n_experts_total"])

    def block(model, x, lp, cast, layer):
        h = x[:, :, None, :]
        x = x + dense.attention(h, h, h, attention_windows(model)[layer],
                                cast)[:, :, 0]
        probs = torch.softmax(x @ lp["router"], dim=-1)
        held = probs[..., :model["n_experts"]]
        y = torch.einsum("bse,bsd,edf->bsf", cast(held), cast(x),
                         cast(lp["moe.w"]))
        aux = probs.mean(dim=(0, 1)).square().sum() * probs.shape[-1]
        return x + y, (aux if with_aux else None)

    fam.leaf_specs, fam.attention_windows = leaf_specs, attention_windows
    fam.token_weights, fam.block = token_weights, block
    fam.embed, fam.loss = dense.embed, dense.loss
    return fam


@pytest.fixture
def toy(monkeypatch):
    """Registers the toy family; returns a setter of its variant."""
    def use(aux_weight=0.5, with_aux=True):
        fam = _toy_family(aux_weight, with_aux)
        monkeypatch.setitem(sys.modules, fam.__name__, fam)
        return fam
    return use


def _batch(model, traffic, seed, step=0):
    return {k: torch.as_tensor(v) for k, v in
            inputs.make_batch(model, traffic, seed, step).items()}


def _walk(fam, model, seed, rows):
    """The reference's layer-by-layer gradient of one micro-batch."""
    ref = reference.Reference(model, TOY_TRAFFIC, seed, torch.device("cpu"))
    b = _batch(model, TOY_TRAFFIC, seed)
    acc = {k: torch.zeros_like(v, dtype=torch.float32)
           for k, v in ref.params.items()}
    loss = ref.micro_batch(b["tokens"][:rows], b["labels"][:rows], acc)
    return acc, loss, ref, b


def _one_graph(fam, ref, tokens, labels, weight):
    """The gradient of ``ce + weight x`` the layers' summed terms, by
    autograd over the whole loss at once, in float32."""
    model = ref.model
    params = {k: v.detach().float().requires_grad_()
              for k, v in ref.params.items()}
    x = fam.embed(params, tokens)
    total = 0.0
    for i in range(model["n_layers"]):
        prefix = f"layers.{i}."
        lp = {k[len(prefix):]: v for k, v in params.items()
              if k.startswith(prefix)}
        x, a = fam.block(model, x, lp, reference.no_cast, i)
        total = total + a
    loss = fam.loss(model, x, params, labels) + weight * total
    loss.backward()
    return {k: v.grad for k, v in params.items()}, float(loss.detach())


def _rel(got, want):
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 9])
def test_the_walk_gives_the_gradient_of_the_whole_loss_with_its_aux(
        toy, seed):
    fam = toy(aux_weight=0.5)
    acc, loss, ref, b = _walk(fam, TOY_MODEL, seed, 2)
    want, want_loss = _one_graph(fam, ref, b["tokens"][:2], b["labels"][:2],
                                 0.5)
    assert set(acc) == set(want)
    for k in acc:
        assert _rel(acc[k], want[k]) <= 1e-5, k
    assert loss == pytest.approx(want_loss, rel=1e-6)
    # the term moves every router by more than rounding
    plain, _ = _one_graph(fam, ref, b["tokens"][:2], b["labels"][:2], 0.0)
    for i in range(TOY_MODEL["n_layers"]):
        k = f"layers.{i}.router"
        assert _rel(plain[k], want[k]) > 1e-2, k


def test_a_weight_of_0_gives_the_gradient_without_the_term(toy):
    fam = toy(aux_weight=0.0)
    acc, loss, ref, b = _walk(fam, TOY_MODEL, 5, 2)
    want, want_loss = _one_graph(fam, ref, b["tokens"][:2], b["labels"][:2],
                                 0.0)
    for k in acc:
        assert _rel(acc[k], want[k]) <= 1e-5, k
    fam = toy(with_aux=False)
    none, none_loss, _, _ = _walk(fam, TOY_MODEL, 5, 2)
    assert all(torch.equal(acc[k], none[k]) for k in acc)
    assert loss == none_loss


def test_a_float32_leaf_is_drawn_updated_and_kept_in_float32(toy):
    toy()
    w = inputs.make_weights(TOY_MODEL, 7, torch.device("cpu"))
    assert w["layers.router"].dtype == torch.float32
    assert w["layers.moe.w"].dtype == torch.bfloat16
    assert w["head"].dtype == torch.bfloat16
    r = w["layers.router"]
    assert not torch.equal(r, r.bfloat16().float())
    ref = reference.Reference(TOY_MODEL, TOY_TRAFFIC, 7, torch.device("cpu"))
    start = {k: v.clone() for k, v in ref.params.items()}
    for step in range(2):
        ref.train_step(_batch(TOY_MODEL, TOY_TRAFFIC, 7, step))
    for k, p in ref.params.items():
        want = torch.float32 if k.endswith(".router") else torch.bfloat16
        assert p.dtype == want, k
        assert ref.m[k].dtype == ref.v[k].dtype == torch.float32, k
        assert not torch.equal(p, start[k]), k
    # the update was not rounded to bfloat16 on the way
    p = ref.params["layers.0.router"]
    assert not torch.equal(p, p.bfloat16().float())


def test_a_steps_flops_count_held_experts_at_top_k_and_each_window(toy):
    toy()
    m, t = TOY_MODEL, TOY_TRAFFIC
    n, d, v = m["n_layers"], m["d_model"], m["vocab"]
    held = n * m["n_experts"] * d * d
    dense_w = d * v + d + n * d * m["n_experts_total"]
    weights = dense_w + held * m["top_k"] // m["n_experts_total"]
    s = t["seq"]
    pairs = sum(1 for w in [3, 0] for i in range(s)
                for j in range(i + 1) if w == 0 or i - j < w)
    want = 6 * weights * s * t["seqs_per_step"] \
        + 12 * d * pairs * t["seqs_per_step"]
    assert train_cell.step_flops(m, t) == want
    # the windowed layers leave fewer pairs than full ones would
    assert pairs < 2 * s * (s + 1) // 2


# --- dense through the widened contract ------------------------------------

def _old_micro_batch(self, tokens, labels, acc):
    """The reference's walk before the contract was widened, frozen: the
    block's output alone backward, the loss without a term (the block
    called as it is now, its output taken)."""
    model, fam = self.model, self.fam
    n = model["n_layers"]
    xs = []
    with torch.no_grad():
        x = fam.embed(self.params, tokens)
        for i in range(n):
            xs.append(x)
            x = fam.block(model, x, self.layer(i, False), self.cast, i)[0]
    x.requires_grad_()
    top = {k: self.params[k].detach().float().requires_grad_()
           for k in ("ln_f.scale", "head")}
    loss = fam.loss(model, x, top, labels)
    loss.backward()
    for k, t in top.items():
        acc[k] += t.grad
    dx = x.grad
    del x, top
    for i in reversed(range(n)):
        xin = xs.pop().requires_grad_()
        lp = self.layer(i, True)
        fam.block(model, xin, lp, self.cast, i)[0].backward(dx)
        for k, t in lp.items():
            acc[f"{reference.LAYER}{i}.{k}"] += t.grad
        dx = xin.grad
        del xin, lp
    acc["embed"].index_add_(0, tokens.reshape(-1),
                            dx.reshape(-1, dx.shape[-1]))
    return float(loss.detach())


def _old_train_step_flops(weights, model, seq, seqs, attn_layers):
    """``workcount.train_step_flops`` before the contract was widened."""
    n = sum(int(np.prod(shape)) for name, shape in weights.items()
            if name != "embed")
    pairs = workcount.unmasked_pairs(seq, True, model.get("window", 0))
    attn = (12 * workcount.head_dim(model) * model["n_heads"] * pairs
            * attn_layers * seqs)
    return 6 * n * seq * seqs + attn


CELLS = ["internlm2-20b.train-4k", "mistral-7b.train-4k"]


@pytest.mark.parametrize("cast", ["no_cast", "fp8_cast"])
@pytest.mark.parametrize("name", CELLS)
def test_dense_readings_are_the_old_walks_bit_for_bit(name, cast,
                                                      monkeypatch):
    cell = tiny(spec.cell(name))
    args = (cell["model"], cell["traffic"], 2 ** 31 + 3, torch.device("cpu"),
            getattr(reference, cast))
    new = reference.readings(*args)
    monkeypatch.setattr(reference.Reference, "micro_batch", _old_micro_batch)
    assert reference.readings(*args) == new


@pytest.mark.parametrize("name", CELLS)
def test_dense_step_flops_are_the_old_integers(name):
    c = spec.cell(name)
    m, t = c["model"], c["traffic"]
    shapes = {s[0]: s[1] for s in inputs.leaf_specs(m)}
    assert train_cell.step_flops(m, t) == _old_train_step_flops(
        shapes, m, t["seq"], t["seqs_per_step"], m["n_layers"])
    assert dense.attention_windows(m) == [m.get("window", 0)] * m["n_layers"]
