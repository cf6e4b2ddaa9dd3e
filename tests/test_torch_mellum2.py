"""Mellum2-12B-A2.5B on the port: the held experts' dropless layer
(``models/moe.py``'s ``held_experts_block``), each layer's window and
rope (``models/model.py``'s ``_dense_block_seq``, ``models/layers.py``'s
YaRN ``rope_freqs``), and the registry's configuration, against the
benchmark's plain float32 reference of the family
(``perfbench/families/moe.py``), which imports nothing of the port.

Both sides take the same weights, drawn by ``perfbench.inputs`` from a
seed, on the CPU in float32.  The JAX package has no such layer, window
pattern or YaRN, so it is not compared here.
"""
import dataclasses
import math

import pytest
import torch

from perfbench import inputs, reference
from perfbench.families import moe as fam
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.models import layers as L
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig, Yarn
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import steps as tsteps

ARCH = "mellum2-12b-a2.5b"
B, S = 2, 32  # 64 tokens a batch
SEED = 2 ** 31 + 34


def _cfg(**over) -> ModelConfig:
    return dataclasses.replace(tconfigs.get_smoke_config(ARCH),
                               dtype=torch.float32,
                               param_dtype=torch.float32, **over)


def _model(cfg: ModelConfig) -> dict:
    """The benchmark's configuration dict of ``cfg``."""
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for key in ("dtype", "param_dtype", "logit_dtype"):
        out[key] = str(out[key]).removeprefix("torch.")
    out["experts_held"] = cfg.n_held
    return out


def _nest(flat):
    tree = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _batch(cfg, seed=SEED):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.vocab, (B, S + 1), generator=g)
    return {"tokens": ids[:, :-1].contiguous(),
            "labels": ids[:, 1:].contiguous()}


def _reference(model, weights, batch):
    """The reference's logits, ce, summed aux and the gradient of ``ce +
    AUX_WEIGHT x aux`` by every leaf (stacked as the program keeps them),
    by autograd over the whole forward."""
    w = {k: v.detach().clone().requires_grad_() for k, v in weights.items()}
    x = fam.embed(w, batch["tokens"])
    aux = 0.0
    for i in range(model["n_layers"]):
        lp = {k[len("layers."):]: v[i] for k, v in w.items()
              if k.startswith("layers.")}
        x, a = fam.block(model, x, lp, reference.no_cast, i)
        aux = aux + a
    logits = fam.rmsnorm(x, w["ln_f.scale"], model["norm_eps"]) @ w["head"]
    ce = fam.loss(model, x, w, batch["labels"])
    (ce + fam.AUX_WEIGHT * aux).backward()
    return logits.detach(), ce.detach(), aux.detach(), \
        {k: v.grad for k, v in w.items()}


def _program(cfg, weights, batch):
    """The port's logits, loss_fn metrics and per-leaf gradients."""
    params = _nest({k: v.detach().clone().requires_grad_()
                    for k, v in weights.items()})
    logits, _ = tmodels.forward(params, cfg, batch["tokens"])
    loss, metrics = tmodels.loss_fn(params, cfg, batch)
    loss.backward()
    return logits.detach(), metrics, {k: v.grad for k, v in
                                      _flat(params).items()}


def _rel(got, want) -> float:
    return float((got - want).norm() / want.norm())


@pytest.fixture(scope="module")
def smoke():
    cfg = _cfg()
    model = _model(cfg)
    weights = inputs.make_weights(model, SEED, torch.device("cpu"))
    batch = _batch(cfg)
    return cfg, model, weights, batch, _reference(model, weights, batch), \
        _program(cfg, weights, batch)


# float32 on both sides; they differ in the order of sums (the chunked
# online softmax against the reference's blocks, the grouped rows against
# dense masked experts) and in the rope's angles (float32 against
# float64).  Over four seeds the logits read at most 1.7e-7
# normwise apart and the worst leaf's gradient 3.8e-7 (wk; ce and aux
# equal): about ten times that is allowed, for another CPU's sum order.
# A dropped YaRN factor or window, or a token routed elsewhere, reads
# 1e-3 and more.
FWD_TOL, GRAD_TOL = 2e-6, 4e-6


def test_the_smoke_config_is_one_period_with_a_share_of_the_experts():
    cfg = tconfigs.get_smoke_config(ARCH)
    assert [cfg.layer_window(i) for i in range(4)] == [8, 8, 8, 0]
    assert [cfg.layer_yarn(i) is not None for i in range(4)] == \
        [False, False, False, True]
    assert (cfg.n_experts, cfg.n_held, cfg.top_k) == (16, 4, 4)
    assert cfg.held_experts and cfg.capacity_factor == 0
    assert fam.attention_windows(_model(cfg)) == [8, 8, 8, 0]


def test_logits_ce_and_aux_match_the_reference(smoke):
    cfg, model, weights, batch, (r_logits, r_ce, r_aux, _), \
        (p_logits, metrics, _) = smoke
    assert _rel(p_logits, r_logits) <= FWD_TOL
    ce, aux = float(metrics["ce"].detach()), float(metrics["aux"].detach())
    assert abs(ce - float(r_ce)) <= FWD_TOL * float(r_ce)
    assert abs(aux - float(r_aux)) <= FWD_TOL * float(r_aux)
    # four layers of a balanced-ish router: the term is near 4 x 1
    assert 3.5 < float(r_aux) < 6.0


def test_every_leafs_gradient_matches_the_reference(smoke):
    *_, (_, _, _, r_grads), (_, _, p_grads) = smoke
    assert set(p_grads) == set(r_grads)
    for k, want in r_grads.items():
        assert want.norm() > 0, k
        assert _rel(p_grads[k], want) <= GRAD_TOL, k


def test_the_counters_count_the_held_assignments(smoke):
    cfg, model, weights, batch, *_ = smoke
    want, load = 0.0, 0.0
    x = fam.embed(weights, batch["tokens"])
    for i in range(cfg.n_layers):
        lp = {k[len("layers."):]: v[i] for k, v in weights.items()
              if k.startswith("layers.")}
        hn = _post_attention(model, x, lp, i)
        idx = torch.topk(torch.softmax(hn @ lp["moe.router"], -1),
                         cfg.top_k, -1).indices
        rows = torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
        held = rows[cfg.expert_offset:cfg.expert_offset + cfg.n_held]
        want += float(held.sum())
        load = max(load, float(held.max() / held.float().mean()))
        x, _ = fam.block(model, x, lp, reference.no_cast, i)
    metrics = smoke[5][1]
    assert float(metrics["moe_held_rows"]) == want
    assert float(metrics["moe_held_load_max"]) == pytest.approx(load)


def _post_attention(model, x, lp, i):
    """The normalised stream the layer's router sees, by the reference."""
    b, s, _ = x.shape
    hd, h, kv = model["d_head"], model["n_heads"], model["n_kv"]
    eps = model["norm_eps"]
    window = fam.attention_windows(model)[i]
    yarn = window == 0
    hn = fam.rmsnorm(x, lp["ln_attn.scale"], eps)
    q = (hn @ lp["attn.wq"]).reshape(b, s, h, hd)
    k = (hn @ lp["attn.wk"]).reshape(b, s, kv, hd)
    v = (hn @ lp["attn.wv"]).reshape(b, s, kv, hd)
    o = fam.attention(fam.rope(q, model, yarn), fam.rope(k, model, yarn), v,
                      window, reference.no_cast)
    x = x + o.reshape(b, s, h * hd) @ lp["attn.wo"]
    return fam.rmsnorm(x, lp["ln_mlp.scale"], eps)


def test_the_train_step_sums_the_counters_over_micro_batches():
    cfg = _cfg()
    state = tsteps.init_train_state(cfg, AdamWConfig(),
                                    torch.Generator().manual_seed(3), "cpu")
    batch = _batch(cfg, 5)
    halves = [{k: v[i:i + 1] for k, v in batch.items()} for i in range(B)]
    parts = [tmodels.loss_fn(state.params, cfg, h)[1] for h in halves]
    _, metrics = tsteps.build_train_step(cfg, AdamWConfig(), B)(state, batch)
    assert float(metrics["moe_held_rows"]) == sum(
        float(p["moe_held_rows"]) for p in parts)
    assert float(metrics["moe_held_load_max"]) == max(
        float(p["moe_held_load_max"]) for p in parts)


# --- one layer: the shares, imbalance --------------------------------------

D, F, E, K = 32, 24, 16, 4


def _layer(seed, held=E, offset=0, x_shift=0.0, bias_expert=None):
    """A layer's normalised input (2, 16, D), router and the whole set of
    experts' weights, and the configuration of a share of them."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((2, 16, D), generator=g) + x_shift
    router = torch.randn((D, E), generator=g) * 0.3
    if bias_expert is not None:
        router[:, bias_expert] = 1.0
    w = {"w_gate": torch.randn((E, D, F), generator=g) * 0.2,
         "w_up": torch.randn((E, D, F), generator=g) * 0.2,
         "w_down": torch.randn((E, F, D), generator=g) * 0.2}
    cfg = ModelConfig(name="layer", family="moe", n_layers=1, d_model=D,
                      n_heads=1, n_kv=1, d_ff=F, vocab=8, n_experts=E,
                      top_k=K, moe_d_ff=F, experts_held=held,
                      expert_offset=offset, capacity_factor=0.0,
                      dtype=torch.float32, param_dtype=torch.float32)
    return x, router, w, cfg


def _share(x, router, w, cfg):
    lo, n = cfg.expert_offset, cfg.n_held
    p = {"router": router, **{k: v[lo:lo + n] for k, v in w.items()}}
    return tmoe.held_experts_block(p, cfg, x)


def _reference_layer(x, router, w, held, offset):
    model = {"n_experts": E, "top_k": K, "experts_held": held,
             "expert_offset": offset}
    lp = {"moe.router": router,
          **{f"moe.{k}": v[offset:offset + held] for k, v in w.items()}}
    return fam.experts(model, x, lp, reference.no_cast)


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5])
def test_the_four_shares_add_up_to_the_whole_layer(seed):
    """Guide section 4's share test: the shares of experts 0-3, 4-7, 8-11
    and 12-15 sum to the layer with every expert held, the port's and the
    uncut reference's; each share's aux is the whole layer's."""
    x, router, w, whole_cfg = _layer(seed)
    whole, whole_aux, whole_c = _share(x, router, w, whole_cfg)
    ref, ref_aux = _reference_layer(x, router, w, E, 0)
    total = torch.zeros_like(whole)
    rows = 0.0
    for offset in range(0, E, 4):
        cfg = dataclasses.replace(whole_cfg, experts_held=4,
                                  expert_offset=offset)
        y, aux, c = _share(x, router, w, cfg)
        part, _ = _reference_layer(x, router, w, 4, offset)
        # a share alone: float32 rounding of the same sums
        assert _rel(y, part) <= 1e-6
        assert torch.equal(aux, whole_aux)
        total += y
        rows += float(c["moe_held_rows"])
    assert _rel(total, whole) <= 1e-6
    assert _rel(total, ref) <= 1e-6
    assert float(whole_aux) == pytest.approx(float(ref_aux), rel=1e-6)
    assert rows == float(whole_c["moe_held_rows"]) == x.shape[0] * \
        x.shape[1] * K


def test_nothing_is_dropped_when_one_held_expert_takes_every_token():
    """The router biased so that held expert 1 is every token's first
    choice: every assignment to a held expert is computed (the capacity
    layer at its default factor would drop most of expert 1's), and the
    output is the reference's."""
    x, router, w, _ = _layer(7, x_shift=2.0, bias_expert=1)
    cfg = _layer(7, held=4, offset=0)[3]
    y, aux, c = _share(x, router, w, cfg)
    ref, ref_aux = _reference_layer(x, router, w, 4, 0)
    probs = torch.softmax(x @ router, -1)
    idx = torch.topk(probs, K, -1).indices
    assert bool((idx[..., 0] == 1).all())
    tokens = x.shape[0] * x.shape[1]
    held = int(((idx >= 0) & (idx < 4)).sum())
    assert float(c["moe_held_rows"]) == held >= tokens
    assert float(c["moe_held_load_max"]) > 2.0  # expert 1 over the mean
    assert _rel(y, ref) <= 1e-6
    assert float(aux) == pytest.approx(float(ref_aux), rel=1e-6)
    cap = dataclasses.replace(cfg, experts_held=0, capacity_factor=1.25)
    assert tmoe.moe_capacity(16, cap) < 16  # the capacity path's slots


def test_the_layers_gradients_match_the_reference():
    x, router, w, cfg = _layer(11, held=4, offset=4)
    lp = {"router": router, **{k: v[4:8] for k, v in w.items()}}
    got = {k: v.clone().requires_grad_() for k, v in lp.items()}
    xg = x.clone().requires_grad_()
    y, aux, _ = tmoe.held_experts_block(got, cfg, xg)
    (y.square().sum() + aux).backward()
    want = {k: v.clone().requires_grad_() for k, v in lp.items()}
    xr = x.clone().requires_grad_()
    model = {"n_experts": E, "top_k": K, "experts_held": 4,
             "expert_offset": 4}
    yr, auxr = fam.experts(model, xr, {f"moe.{k}": v
                                       for k, v in want.items()},
                           reference.no_cast)
    (yr.square().sum() + auxr).backward()
    assert _rel(xg.grad, xr.grad) <= 1e-5
    for k in got:
        assert _rel(got[k].grad, want[k].grad) <= 1e-5, k


def _buffers(x, router, w, cfg):
    """What the held layer hands the grouped products: the rows' shape
    and the groups' ends."""
    seen, real = [], tmoe._HeldExperts.apply

    def spy(rows, offs, *ws):
        seen.append((tuple(rows.shape), offs.tolist()))
        return real(rows, offs, *ws)

    tmoe._HeldExperts.apply = spy
    try:
        _share(x, router, w, cfg)
    finally:
        tmoe._HeldExperts.apply = real
    return seen[0]


def test_the_buffers_do_not_depend_on_the_routing():
    """Every group padded to a multiple of 16 rows, an empty one to 16;
    the buffer a row an assignment and the padding, however the tokens
    route, so nothing is read back to size it."""
    x, router, w, cfg = _layer(13, held=4, offset=0)
    even = _buffers(x, router, w, cfg)
    xb, rb, wb, _ = _layer(7, x_shift=2.0, bias_expert=1)
    skewed = _buffers(xb, rb, wb, cfg)
    n = x.shape[0] * x.shape[1] * K
    for shape, ends in (even, skewed):
        assert shape == (n + 4 * tmoe.GROUP_ROWS, D)
        sizes = [b - a for a, b in zip([0] + ends[:-1], ends)]
        assert all(s % tmoe.GROUP_ROWS == 0 and s >= tmoe.GROUP_ROWS
                   for s in sizes)
    assert even[1] != skewed[1]


def test_the_layer_on_a_one_rank_mesh_is_the_plain_one():
    """On DTensors over a 1 x 1 mesh: routing, the experts and the combine
    on each rank's block, output, aux, counters and gradients the plain
    call's."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    created = not dist.is_initialized()
    mesh = make_host_mesh(1, 1, device="cpu")
    try:
        _one_rank_case(mesh)
    finally:
        if created:
            dist.destroy_process_group()


def _one_rank_case(mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x, router, w, cfg = _layer(17, held=4, offset=8)
    lp = {"router": router, **{k: v[8:12] for k, v in w.items()}}
    plain = {k: v.clone().requires_grad_() for k, v in lp.items()}
    y, aux, c = tmoe.held_experts_block(plain, cfg, x)
    (y.square().sum() + aux).backward()
    rep = [Replicate(), Replicate()]
    dt = {k: DTensor.from_local(v.clone(), mesh, rep).requires_grad_()
          for k, v in lp.items()}
    xd = DTensor.from_local(x.clone(), mesh, [Shard(0), Replicate()])
    yd, auxd, cd = tmoe.held_experts_block(dt, cfg, xd)
    (yd.square().sum() + auxd).backward()
    assert torch.equal(yd.full_tensor(), y)
    assert torch.equal(auxd.full_tensor(), aux)
    for k in c:
        assert torch.equal(cd[k].full_tensor(), c[k]), k
    for k in plain:
        assert torch.allclose(dt[k].grad.full_tensor(), plain[k].grad,
                              rtol=1e-6, atol=1e-9), k


# --- windows and rope --------------------------------------------------------

def test_yarn_frequencies_are_the_published_formula():
    """``rope_freqs`` with Mellum2's full layers' parameters against the
    formula written out in float64 (transformers'
    ``_compute_yarn_parameters``): the ramp from dim 18 to 35."""
    cfg = tconfigs.get_config(ARCH)
    yarn = cfg.layer_yarn(3)
    assert yarn == Yarn(16.0, 8192, 32.0, 1.0, 1.2772588722239782)
    d, theta = cfg.head_dim, cfg.rope_theta

    def dim(r):
        return d * math.log(8192 / (2 * math.pi * r)) / (2 * math.log(theta))

    low, high = max(math.floor(dim(32)), 0), min(math.ceil(dim(1)), d - 1)
    assert (low, high) == (18, 35)
    want = []
    for i in range(d // 2):
        inv = theta ** (-2 * i / d)
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(inv / 16 * ramp + inv * (1 - ramp))
    got = L.rope_freqs(d, theta, yarn=yarn)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.tensor(want, dtype=torch.float64).float())
    # no YaRN: the old float32 expression, bit for bit
    plain = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32) / d))
    assert torch.equal(L.rope_freqs(d, theta), plain)
    # the reference's wavelengths are the same
    inv, scale = fam.inv_wavelengths(_model(cfg), d, True)
    assert torch.equal(inv.float(), got) and scale == yarn.attention_factor


def test_the_attention_factor_scales_q_dot_k_by_its_square():
    cfg = tconfigs.get_config(ARCH)
    yarn = cfg.layer_yarn(3)
    unit = dataclasses.replace(yarn, attention_factor=1.0)
    g = torch.Generator().manual_seed(4)
    q = torch.randn((1, 64, 2, 128), generator=g)
    k = torch.randn((1, 64, 2, 128), generator=g)
    pos = torch.arange(64)[None] + 5000
    dots = (L.apply_rope(q, pos, 5e5, yarn)
            * L.apply_rope(k, pos.flip(-1), 5e5, yarn)).sum(-1)
    plain = (L.apply_rope(q, pos, 5e5, unit)
             * L.apply_rope(k, pos.flip(-1), 5e5, unit)).sum(-1)
    # the rotation is float32: the two sums of 128 terms round apart
    assert torch.allclose(dots, plain * yarn.attention_factor ** 2,
                          rtol=1e-5, atol=1e-5)
    assert not torch.allclose(L.apply_rope(q, pos, 5e5, unit),
                              L.apply_rope(q, pos, 5e5), rtol=1e-3)


def _attention_of_layer(cfg, lp, x, i):
    """``_dense_block_seq``'s attention residual of layer ``i`` by hand:
    the projections, the rope and ``chunked_attention`` at the layer's
    window."""
    b, s, _ = x.shape
    hn = L.rmsnorm(lp["ln_attn"], x, cfg.norm_eps)
    q = (hn @ lp["attn"]["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (hn @ lp["attn"]["wk"]).reshape(b, s, cfg.n_kv, cfg.head_dim)
    v = (hn @ lp["attn"]["wv"]).reshape(b, s, cfg.n_kv, cfg.head_dim)
    pos = torch.arange(s)[None].expand(b, s)
    yarn = cfg.layer_yarn(i)
    q = L.apply_rope(q, pos, cfg.rope_theta, yarn)
    k = L.apply_rope(k, pos, cfg.rope_theta, yarn)
    o = L.chunked_attention(q, k, v, causal=True,
                            window=cfg.layer_window(i), chunk=cfg.attn_chunk)
    return x + o.reshape(b, s, -1) @ lp["attn"]["wo"]


def test_a_windowed_layer_is_chunked_attention_at_its_window(monkeypatch):
    cfg = _cfg()
    params = tmodels.init_model(cfg, torch.Generator().manual_seed(8), "cpu")
    lp = tmodel._unstack(params, "layers", cfg.n_layers)[0]
    x = torch.randn((B, S, cfg.d_model),
                    generator=torch.Generator().manual_seed(9))
    got, real = {}, tmoe.held_experts_block

    def spy(p, cfg_, x_, *rest):  # the normalised residual before the MLP
        got["x"] = x_
        return real(p, cfg_, x_, *rest)

    monkeypatch.setattr(tmoe, "held_experts_block", spy)
    for i in (0, 3):
        tmodel._dense_block_seq(cfg, x, lp, None, layer=i)
        want = _attention_of_layer(cfg, lp, x, i)
        mlp_in = L.rmsnorm(lp["ln_mlp"], want, cfg.norm_eps)
        assert torch.equal(got["x"], mlp_in), i
    # the window is passed: layer 0 over all keys would differ
    full = dataclasses.replace(cfg, window=0, full_every=0, yarn_factor=0)
    tmodel._dense_block_seq(full, x, lp, None, layer=0)
    assert not torch.allclose(got["x"], L.rmsnorm(
        lp["ln_mlp"], _attention_of_layer(cfg, lp, x, 0), cfg.norm_eps))


def _old_dense_block_seq(cfg, x, lp, positions, cache=None,
                         cache_index=None, layer=0):
    """``_dense_block_seq`` before it took a layer: no window, no YaRN."""
    h, new_cache = L.attention_layer(
        lp["attn"], cfg, L.rmsnorm(lp["ln_attn"], x, cfg.norm_eps),
        positions=positions, causal=True, cache=cache,
        cache_index=cache_index)
    x = x + h
    y = L.mlp(lp["mlp"], L.rmsnorm(lp["ln_mlp"], x, cfg.norm_eps))
    return x + y, torch.zeros((), dtype=torch.float32), new_cache, {}


@pytest.mark.parametrize("arch", ["llama3_8b", "internlm2_20b"])
def test_a_dense_config_without_a_window_is_bit_for_bit_as_before(
        arch, monkeypatch):
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                              dtype=torch.float32,
                              param_dtype=torch.float32)
    assert cfg.window == 0
    params = tmodels.init_model(cfg, torch.Generator().manual_seed(2), "cpu")
    batch = _batch(cfg, 6)
    new = tmodels.forward(params, cfg, batch["tokens"])[0]
    monkeypatch.setattr(tmodel, "_dense_block_seq", _old_dense_block_seq)
    old = tmodels.forward(params, cfg, batch["tokens"])[0]
    assert torch.equal(new, old)


def test_a_dense_window_now_reaches_attention():
    """A dense configuration's ``window`` (Mistral's) on every layer."""
    base = dataclasses.replace(tconfigs.get_smoke_config("llama3_8b"),
                               dtype=torch.float32,
                               param_dtype=torch.float32)
    cfg = dataclasses.replace(base, window=8)
    assert [cfg.layer_window(i) for i in range(cfg.n_layers)] == \
        [8] * cfg.n_layers
    assert all(cfg.layer_yarn(i) is None for i in range(cfg.n_layers))
    params = tmodels.init_model(cfg, torch.Generator().manual_seed(2), "cpu")
    tokens = _batch(cfg, 6)["tokens"]
    windowed = tmodels.forward(params, cfg, tokens)[0]
    full = tmodels.forward(params, base, tokens)[0]
    # the first 8 positions see the same keys either way
    assert torch.equal(windowed[:, :8], full[:, :8])
    assert not torch.allclose(windowed[:, 8:], full[:, 8:])


# --- serving and the registry -----------------------------------------------

@pytest.mark.parametrize("field", ["full_every", "yarn_factor",
                                   "experts_held", "capacity_factor"])
def test_prefill_and_decode_raise_for_the_new_fields(field):
    base = dataclasses.replace(
        tconfigs.get_smoke_config("qwen2_moe_a2_7b"), dtype=torch.float32,
        param_dtype=torch.float32)
    cfg = dataclasses.replace(base, **{
        "full_every": {"full_every": 2, "window": 8},
        "yarn_factor": {"yarn_factor": 4.0, "yarn_original_max": 32},
        "experts_held": {"experts_held": 2},
        "capacity_factor": {"capacity_factor": 0.0}}[field])
    params = tmodels.init_model(cfg, torch.Generator().manual_seed(1), "cpu")
    tokens = torch.zeros((1, 8), dtype=torch.long)
    name = field if field in ("full_every", "yarn_factor") \
        else "experts_held/capacity_factor"
    with pytest.raises(NotImplementedError, match=name):
        tmodels.prefill(params, cfg, tokens)
    cache = tmodels.init_cache(base, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match=name):
        tmodels.decode_step(params, cfg, cache, tokens[:, :1])


def test_the_registry_holds_mellum2_beside_the_packages_archs():
    assert "mellum2_12b_a2_5b" not in tconfigs.ARCHS
    for alias in (ARCH, "mellum2_12b_a2_5b", "mellum2-12b-a2-5b"):
        assert tconfigs.canonical(alias) == "mellum2_12b_a2_5b"
    cfg = tconfigs.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv,
            cfg.head_dim) == (28, 2304, 32, 4, 128)
    assert (cfg.n_experts, cfg.n_held, cfg.top_k, cfg.moe_d_ff,
            cfg.n_shared) == (64, 64, 8, 896, 0)
    assert cfg.held_experts and cfg.vocab == 98304
    assert [cfg.layer_window(i) for i in range(8)] == [1024] * 3 + [0] + \
        [1024] * 3 + [0]


def _count(cfg) -> int:
    params = tmodels.abstract_params(cfg)
    return tmodels.param_count(params)


def test_the_parameter_counts_of_the_model_and_the_cells_share():
    """12.15 B parameters with all 64 experts (the model's "12B"); 2.44 B
    with 8 held, the benchmark's cell, equal to its family's leaves."""
    cfg = tconfigs.get_config(ARCH)
    layer = 2 * 2304 + 2304 * (4096 + 2 * 512) + 4096 * 2304 + 2304 * 64
    expert = 3 * 2304 * 896
    top = 2 * 98304 * 2304 + 2304
    assert _count(cfg) == 28 * (layer + 64 * expert) + top \
        == 12_149_915_904
    share = dataclasses.replace(cfg, experts_held=8)
    assert _count(share) == 28 * (layer + 8 * expert) + top
    model = _model(share)
    assert sum(math.prod(s[1]) for s in fam.leaf_specs(model)) == \
        _count(share)
