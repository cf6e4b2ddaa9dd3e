"""The port's training path against the JAX package's, on the CPU.

Numpy-seeded inputs go through both packages: AdamW (``TestAdamW``'s
cases, 1e-6 relative), int8 compression (bit for bit: ``torch.round`` and
``jnp.round`` both round half to even), ``SyntheticLM`` (bit for bit, the
same numpy streams), ``loss_fn`` and its per-leaf gradients on the griffin
smoke config with two tail layers (1e-4 normwise per leaf in float32, 2e-2
in bfloat16: ``tests/test_models.py``'s tolerances), one
``build_train_step`` step (loss 1e-5 relative, parameters within 2.6 x
lr, the bound of ``tests/test_runtime.py``), checkpoints across the
packages in both directions and an async save against in-place steps,
the straggler monitor, the legacy experiment shims (bit for bit on a
golden case each) and the training entry point.  The JAX side is jitted.
"""
import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro import models as jmodels
from repro import optim as joptim
from repro.configs.metronome_testbed import MODEL_FLEET as JFLEET
from repro.configs.metronome_testbed import make_snapshot as jsnapshot
from repro.core import harness as jharness
from repro.core.simulator import SimConfig as JSimConfig
from repro.core.trace import generate_trace as jgenerate_trace
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import layers as jlayers
from repro.runtime import steps as jsteps
from repro.runtime import straggler as jstraggler
from repro_torch import _tree
from repro_torch import checkpoint as tckpt
from repro_torch.checkpoint import checkpoint as tckpt_module
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch import optim as toptim
from repro_torch.configs.metronome_testbed import make_snapshot as tsnapshot
from repro_torch.core import harness as tharness
from repro_torch.core import trace as ttrace
from repro_torch.core.simulator import SimConfig as TSimConfig
from repro_torch.data import SyntheticLM, packed_batch_iterator
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tlayers
from repro_torch.runtime import steps as tsteps
from repro_torch.runtime.straggler import StragglerMonitor

ARCH = "recurrentgemma_2b"
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
ADAM_TOL = 1e-6


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel_close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=0,
                               err_msg=what)


def _normwise(got, want) -> float:
    g, w = _np(got), _np(want)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _adam_pair(**kw):
    jkw = dict(kw)
    tkw = dict(kw)
    if "moment_dtype" in kw:
        jkw["moment_dtype"] = jnp.bfloat16
        tkw["moment_dtype"] = torch.bfloat16
    return joptim.AdamWConfig(**jkw), toptim.AdamWConfig(**tkw)


def _run_adam(jcfg, tcfg, params, grads_seq):
    jp = jax.tree.map(jnp.asarray, params)
    tp = _tree.tree_map(lambda a: torch.tensor(a), params)
    jst, tst = joptim.adamw_init(jcfg, jp), toptim.adamw_init(tcfg, tp)
    jupd = jax.jit(lambda p, g, s: joptim.adamw_update(jcfg, p, g, s))
    for grads in grads_seq:
        jp, jst, jm = jupd(jp, jax.tree.map(jnp.asarray, grads), jst)
        tp, tst, tm = toptim.adamw_update(
            tcfg, tp, _tree.tree_map(lambda a: torch.tensor(a), grads), tst)
        for k in ("grad_norm", "lr"):
            _rel_close(tm[k], jm[k], ADAM_TOL, k)
    return jp, jst, tp, tst


class TestAdamW:
    def test_matches_reference_closed_form(self):
        jcfg, tcfg = _adam_pair(lr=1e-2, b1=0.9, b2=0.99, eps=1e-8,
                                weight_decay=0.0, grad_clip=0.0,
                                warmup_steps=0, total_steps=10,
                                min_lr_frac=1.0)
        p = {"w": np.array([1.0, -2.0, 3.0], np.float32)}
        g = {"w": np.array([0.1, 0.2, -0.3], np.float32)}
        jp, _, tp, _ = _run_adam(jcfg, tcfg, p, [g])
        _rel_close(tp["w"], jp["w"], ADAM_TOL)
        m = 0.1 * g["w"].astype(float) / (1 - 0.9)
        v = 0.01 * g["w"].astype(float) ** 2 / (1 - 0.99)
        want = p["w"] - 1e-2 * m / (np.sqrt(v) + 1e-8)
        np.testing.assert_allclose(_np(tp["w"]), want, rtol=1e-5)

    def test_grad_clip(self):
        jcfg, tcfg = _adam_pair(grad_clip=1.0, warmup_steps=0)
        p = {"w": np.ones(4, np.float32)}
        g = {"w": np.full(4, 100.0, np.float32)}
        jp, _, tp, _ = _run_adam(jcfg, tcfg, p, [g])
        _rel_close(tp["w"], jp["w"], ADAM_TOL)
        _, _, metrics = toptim.adamw_update(
            tcfg, {"w": torch.ones(4)}, {"w": torch.full((4,), 100.0)},
            toptim.adamw_init(tcfg, {"w": torch.ones(4)}))
        assert float(metrics["grad_norm"]) == pytest.approx(200.0)

    @pytest.mark.parametrize("step", [0, 5, 10, 40, 100, 250])
    def test_schedule_warmup_and_decay(self, step):
        jcfg, tcfg = _adam_pair(lr=1.0, warmup_steps=10, total_steps=100,
                                min_lr_frac=0.1)
        got = toptim.cosine_schedule(tcfg, torch.tensor(step))
        assert got.dtype == torch.float32
        _rel_close(got, joptim.cosine_schedule(jcfg, jnp.asarray(step)),
                   ADAM_TOL)
        want = {5: 0.5, 10: 1.0, 100: 0.1}.get(step)
        if want is not None:
            assert float(got) == pytest.approx(want)

    def test_bf16_moments(self):
        jcfg, tcfg = _adam_pair(moment_dtype="bf16", warmup_steps=0)
        st = toptim.adamw_init(tcfg, {"w": torch.ones(4)})
        assert st["m"]["w"].dtype == torch.bfloat16
        rng = np.random.default_rng(0)
        p = {"w": rng.normal(size=64).astype(np.float32)}
        gs = [{"w": rng.normal(size=64).astype(np.float32)} for _ in range(3)]
        jp, jst, tp, tst = _run_adam(jcfg, tcfg, p, gs)
        _rel_close(tp["w"], jp["w"], ADAM_TOL)
        _rel_close(tst["m"]["w"], jst["m"]["w"], 1e-2)

    def test_tree_over_steps_with_decay_and_clipping(self):
        """A nested tree of several leaves, three steps, weight decay and
        clipping that engages: every leaf, moment and metric at 1e-6."""
        jcfg, tcfg = _adam_pair(lr=3e-3, warmup_steps=2, total_steps=20,
                                grad_clip=0.5)
        rng = np.random.default_rng(1)
        shapes = {"b": {"z": (5,), "a": (3, 4)}, "a": (7,)}

        def draw(scale):
            return _tree.tree_map(
                lambda s: (scale * rng.normal(size=s)).astype(np.float32),
                shapes)

        p = draw(1.0)
        gs = [draw(0.3 * (k + 1)) for k in range(3)]
        jp, jst, tp, tst = _run_adam(jcfg, tcfg, p, gs)
        for got, want in ((tp, jp), (tst["m"], jst["m"]), (tst["v"], jst["v"])):
            for a, b in zip(_tree.leaves(got), jax.tree.leaves(want)):
                _rel_close(a, b, ADAM_TOL)
        assert int(tst["step"]) == int(jst["step"]) == 3


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------

class TestCompression:
    def test_quantize_int8_bit_for_bit(self):
        x = (np.random.default_rng(0).normal(size=513) * 5).astype(np.float32)
        x[:4] = [0.5, -0.5, 2.5, 127.0]  # ties round half to even
        jq, js = joptim.quantize_int8(jnp.asarray(x))
        tq, ts = toptim.quantize_int8(torch.tensor(x))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert float(ts) == float(js)
        err = (tq.float() * ts - torch.tensor(x)).abs().max()
        assert float(err) <= float(ts) / 2 + 1e-6

    def test_error_feedback_bit_for_bit(self):
        rng = np.random.default_rng(1)
        g = {"w": np.full(64, 0.01234, np.float32),
             "b": {"c": rng.normal(size=(3, 5)).astype(np.float32)}}
        jg, tg = jax.tree.map(jnp.asarray, g), _tree.tree_map(torch.tensor, g)
        jef, tef = joptim.make_ef_state(jg), toptim.make_ef_state(tg)
        total = torch.zeros(64)
        for _ in range(50):
            jqs, jef = joptim.compress_ef_int8(jg, jef)
            tqs, tef = toptim.compress_ef_int8(tg, tef)
            for a, b in zip(_tree.leaves(toptim.decompress_ef_int8(tqs)),
                            jax.tree.leaves(joptim.decompress_ef_int8(jqs))):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            for a, b in zip(_tree.leaves(tef), jax.tree.leaves(jef)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            total += tqs["w"][0].float() * tqs["w"][1]
        assert float((total / 50 - 0.01234).abs().max()) < 1e-4


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

class TestData:
    @pytest.mark.parametrize("step", [0, 5, 6])
    def test_batches_bit_for_bit(self, step):
        kw = dict(vocab=100, seq_len=8, global_batch=4, seed=3)
        want, got = JSyntheticLM(**kw).batch_at(step), \
            SyntheticLM(**kw).batch_at(step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        assert got["tokens"].min() >= 1  # 0 reserved

    def test_prefetching_iterator_replays_batch_at(self):
        ds = SyntheticLM(vocab=50, seq_len=6, global_batch=2, seed=1)
        it = packed_batch_iterator(ds, start_step=4)
        for step in range(4, 7):
            got = next(it)
            np.testing.assert_array_equal(got["tokens"],
                                          ds.batch_at(step)["tokens"])
        it.close()


# ---------------------------------------------------------------------------
# Model: loss, gradients, train step
# ---------------------------------------------------------------------------

def _configs(dtype: str, n_layers: int = 8):
    jd, td, _ = DTYPES[dtype]
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), dtype=jd,
                               param_dtype=jd, n_layers=n_layers)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype=td,
                               param_dtype=td, n_layers=n_layers)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    jparams, _ = jmodels.init_model(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), jparams)
    return jparams, tmodels.params_from_jax(tree, tcfg, "cpu")


def _batch(vocab, b=4, s=24, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, (b, s))
    labels = rng.integers(1, vocab, (b, s))
    labels[0, :5] = -1  # masked
    return ({"tokens": jnp.asarray(tokens, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)},
            {"tokens": torch.as_tensor(tokens),
             "labels": torch.as_tensor(labels)})


def _grads(tparams, tcfg, batch):
    xs = [p.detach().requires_grad_() for p in _tree.leaves(tparams)]
    loss, metrics = tmodels.loss_fn(_tree.rebuild(tparams, xs), tcfg, batch)
    return loss, metrics, torch.autograd.grad(loss, xs)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_loss_and_per_leaf_gradients(dtype):
    jcfg, tcfg = _configs(dtype)
    jparams, tparams = _params(jcfg, tcfg)
    jb, tb = _batch(jcfg.vocab)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodels.loss_fn(p, jcfg, jb), has_aux=True))(jparams)
    tl, tm, tg = _grads(tparams, tcfg, tb)
    tol = DTYPES[dtype][2]
    _rel_close(tl, jl, tol, "loss")
    _rel_close(tm["ce"], jm["ce"], tol, "ce")
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    assert int(tm["tokens"]) == int(jm["tokens"]) == 4 * 24 - 5
    names = ["/".join(map(str, path)) for path, _ in
             jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert len(tg) == len(names)
    for name, got, want in zip(names, tg, jax.tree.leaves(jg)):
        assert got.dtype == DTYPES[dtype][1] or name.endswith("'lam']")
        err = _normwise(got, want)
        assert err <= tol, f"{name}: normwise {err}"
        assert float(got.float().norm()) > 0, name


def _counting_rg_lru(monkeypatch):
    calls = []
    real = ops.rg_lru

    def counted(a, x):
        calls.append(tuple(x.shape))
        return real(a, x)

    monkeypatch.setattr(ops, "rg_lru", counted)
    return calls


@pytest.mark.parametrize("remat", [True, False])
def test_remat_recomputes_each_group_and_tail_layer(monkeypatch, remat):
    """With remat the backward pass reruns every RG-LRU sublayer (2 per
    group, 1 per tail layer) and the gradients are unchanged."""
    _, tcfg = _configs("float32")
    _, tparams = _params(*_configs("float32"))
    _, tb = _batch(tcfg.vocab, b=2, s=12)
    _, _, want = _grads(tparams, dataclasses.replace(tcfg, remat=False), tb)
    calls = _counting_rg_lru(monkeypatch)
    _, _, got = _grads(tparams, dataclasses.replace(tcfg, remat=remat), tb)
    n_rg = 2 * 2 + 2  # 2 groups, 2 tail layers
    assert len(calls) == (2 if remat else 1) * n_rg
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    calls.clear()
    with torch.no_grad():
        tmodels.forward(tparams, tcfg, tb["tokens"])
    assert len(calls) == n_rg  # no recompute without autograd


@pytest.fixture(scope="module")
def one_step():
    """One train step of each package from the same state and batch."""
    jcfg, tcfg = _configs("bfloat16")
    jopt = joptim.AdamWConfig(lr=1e-3, warmup_steps=0)
    topt = toptim.AdamWConfig(lr=1e-3, warmup_steps=0)
    jstate, _ = jsteps.init_train_state(jcfg, jopt, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jstate.params)
    tstate = tsteps.init_train_state(tcfg, topt, torch.Generator(), "cpu")
    tstate.params = tmodels.params_from_jax(tree, tcfg, "cpu")
    jb, tb = _batch(jcfg.vocab, b=4, s=16, seed=2)
    js, jm = jax.jit(jsteps.build_train_step(jcfg, jopt, n_micro=2))(jstate, jb)
    ts, tm = tsteps.build_train_step(tcfg, topt, n_micro=2)(tstate, tb)
    return js, jm, ts, tm, topt


def test_train_step_matches_the_reference(one_step):
    js, jm, ts, tm, topt = one_step
    _rel_close(tm["loss"], jm["loss"], 1e-5, "loss")
    for k in ("grad_norm", "lr", "aux"):
        np.testing.assert_allclose(_np(tm[k]), _np(jm[k]), rtol=2e-2,
                                   atol=1e-7, err_msg=k)
    assert int(ts.step) == int(js.step) == 1
    assert int(ts.opt["step"]) == int(js.opt["step"]) == 1
    for a, b in zip(_tree.leaves(ts.params), jax.tree.leaves(js.params)):
        # bf16 parameters and Adam's sign-like first step: a near-zero
        # gradient summed in another order can flip, so the reference's
        # bound of ~2 x lr plus a bf16 rounding (2.6e-3 at lr 1e-3,
        # tests/test_runtime.py) holds, not equality
        np.testing.assert_allclose(_np(a), _np(b), atol=2.6 * topt.lr)


def test_train_step_metrics_and_state(one_step):
    _, _, ts, tm, _ = one_step
    assert set(tm) == {"loss", "aux", "grad_norm", "lr"}
    assert all(v.dtype == torch.float32 and v.dim() == 0 for v in tm.values())
    # the first moment is (1 - b1) * clipped g: non-zero on every leaf
    for m in _tree.leaves(ts.opt["m"]):
        assert m.dtype == torch.float32 and float(m.norm()) > 0


def test_micro_equivalence():
    """n_micro=4 must equal n_micro=1 on the same global batch (the port
    against itself, the reference's own check)."""
    _, tcfg = _configs("bfloat16")
    opt = toptim.AdamWConfig(lr=1e-3, warmup_steps=0)
    _, tb = _batch(tcfg.vocab, b=8, s=16, seed=3)
    tb["labels"] = tb["tokens"]  # no masked label: equal-weight micro means
    out = []
    for n_micro in (1, 4):
        state = tsteps.init_train_state(
            tcfg, opt, torch.Generator().manual_seed(0), "cpu")
        out.append(tsteps.build_train_step(tcfg, opt, n_micro)(state, tb))
    (s1, m1), (s4, m4) = out
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-5)
    for a, b in zip(_tree.leaves(s1.params), _tree.leaves(s4.params)):
        np.testing.assert_allclose(_np(a), _np(b), atol=2.6e-3)


@pytest.mark.parametrize("compress", [False, True],
                         ids=["plain", "compress_grads"])
def test_loss_decreases_over_steps(compress):
    """12 steps on one repeated batch (``test_loss_decreases_over_steps``);
    with int8-compressed gradients 10 steps (``TestCompressedGrads``)."""
    tcfg = tconfigs.get_smoke_config(ARCH)
    opt = toptim.AdamWConfig(lr=3e-3, warmup_steps=0,
                             total_steps=30 if compress else 50)
    state = tsteps.init_train_state(tcfg, opt,
                                    torch.Generator().manual_seed(0), "cpu")
    step = tsteps.build_train_step(tcfg, opt, n_micro=1,
                                   compress_grads=compress)
    batch = {k: torch.as_tensor(v) for k, v in
             SyntheticLM(tcfg.vocab, 16, 8, seed=0).batch_at(0).items()}
    losses = []
    for _ in range(10 if compress else 12):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - (0.15 if compress else 0.2)


def test_auto_microbatches_matches_the_reference():
    for name, shape in tmodels.SHAPES.items():
        for shards in (1, 4, 16):
            jshape = jmodels.SHAPES[name]
            assert tsteps.auto_microbatches(None, shape, shards) == \
                jsteps.auto_microbatches(None, jshape, shards)


def test_grad_bf16_barrier():
    x = np.random.default_rng(0).normal(size=(4, 8)).astype(np.float32)
    w = np.random.default_rng(1).normal(size=(4, 8)).astype(np.float32)
    jg = jax.grad(lambda x: jnp.sum(jlayers.grad_bf16_barrier(x) * w))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    y = tlayers.grad_bf16_barrier(xt)
    assert torch.equal(y, xt)
    (tg,) = torch.autograd.grad((y * torch.tensor(w)).sum(), xt)
    np.testing.assert_array_equal(_np(tg), _np(jg))
    assert not torch.equal(tg, torch.tensor(w))  # the cotangent was rounded


# ---------------------------------------------------------------------------
# Checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def states():
    """A JAX and a port train state of the same structure, different
    values."""
    jcfg, tcfg = _configs("bfloat16", n_layers=4)
    jopt = joptim.AdamWConfig()
    topt = toptim.AdamWConfig()
    jstate, _ = jsteps.init_train_state(jcfg, jopt, jax.random.PRNGKey(1))
    jstate = dataclasses.replace(jstate, step=jnp.asarray(7, jnp.int32))
    tstate = tsteps.init_train_state(tcfg, topt,
                                     torch.Generator().manual_seed(2), "cpu")
    tstate.opt["m"] = _tree.tree_map(lambda p: torch.full_like(p, 0.25),
                                     tstate.opt["m"])
    tstate.opt["step"] = torch.tensor(3, dtype=torch.int32)
    tstate.step = torch.tensor(5, dtype=torch.int32)
    return jstate, tstate


def _assert_state_equal(tstate, jstate):
    got, want = _tree.leaves(tstate), jax.tree.leaves(jstate)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == {jnp.bfloat16: torch.bfloat16,
                           jnp.float32: torch.float32,
                           jnp.int32: torch.int32}[jnp.dtype(b.dtype).type]
        np.testing.assert_array_equal(_np(a), _np(b))


class TestCheckpoint:
    def test_jax_save_port_restore(self, tmp_path, states):
        jstate, tstate = states
        jckpt.save_checkpoint(str(tmp_path), 7, jstate, {"note": "jax"})
        got, step, extra = tckpt.restore_checkpoint(str(tmp_path), tstate)
        assert step == 7 and extra == {"note": "jax"}
        assert isinstance(got, tsteps.TrainState)
        _assert_state_equal(got, jstate)

    def test_port_save_jax_restore(self, tmp_path, states):
        jstate, tstate = states
        tckpt.save_checkpoint(str(tmp_path), 5, tstate)
        got, step, _ = jckpt.restore_checkpoint(str(tmp_path), jstate)
        assert step == 5
        _assert_state_equal(tstate, got)

    def test_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(6).reshape(2, 3),
                "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
        tckpt.save_checkpoint(str(tmp_path), 7, tree, {"note": "x"})
        got, step, extra = tckpt.restore_checkpoint(str(tmp_path), tree)
        assert step == 7 and extra == {"note": "x"}
        assert torch.equal(got["a"], tree["a"])
        assert got["b"]["c"].dtype == torch.bfloat16

    def test_corrupt_checkpoint_skipped(self, tmp_path):
        tree = {"a": torch.ones(3)}
        tckpt.save_checkpoint(str(tmp_path), 1, tree)
        tckpt.save_checkpoint(str(tmp_path), 2, tree)
        os.remove(os.path.join(str(tmp_path), "step_00000002",
                               "manifest.json"))
        assert tckpt.latest_step(str(tmp_path)) == 1

    def test_keep_n_and_async(self, tmp_path):
        mgr = tckpt.CheckpointManager(str(tmp_path), keep_n=2,
                                      async_save=True)
        tree = {"a": torch.ones(3)}
        for s in range(5):
            tree["a"] += 1  # saved as it stood at save(), not later
            mgr.save(s, tree)
        mgr.wait()
        steps = sorted(n for n in os.listdir(str(tmp_path))
                       if n.startswith("step_"))
        assert steps == ["step_00000003", "step_00000004"]
        got, step, _ = mgr.restore_latest(tree)
        assert step == 4 and float(got["a"][0]) == 6.0

    def test_async_save_holds_the_saved_steps_values(self, tmp_path,
                                                     monkeypatch):
        """An async save taken before another train step holds the saved
        step's parameters and moments: the step updates them in place
        while the writer runs (held here until that step is done)."""
        _, tcfg = _configs("float32", n_layers=4)
        opt = toptim.AdamWConfig(lr=1e-3, warmup_steps=0)
        state = tsteps.init_train_state(
            tcfg, opt, torch.Generator().manual_seed(0), "cpu")
        step = tsteps.build_train_step(tcfg, opt, n_micro=1)
        _, tb = _batch(tcfg.vocab, b=2, s=12)
        state, _ = step(state, tb)
        want = [x.clone() for x in _tree.leaves(state)]
        go = threading.Event()
        write = tckpt_module._write

        def held(*args):
            go.wait(timeout=60)
            return write(*args)

        monkeypatch.setattr(tckpt_module, "_write", held)
        mgr = tckpt.CheckpointManager(str(tmp_path), async_save=True)
        mgr.save(1, state)
        state, _ = step(state, tb)
        go.set()
        mgr.wait()
        got, saved_step, _ = tckpt.restore_checkpoint(str(tmp_path), state,
                                                      step=1)
        assert saved_step == 1
        moved = 0
        for w, now, g in zip(want, _tree.leaves(state), _tree.leaves(got)):
            assert torch.equal(g, w)
            moved += not torch.equal(now, w)
        assert moved > len(want) // 2  # the second step did move them

    def test_wrong_structure_refused(self, tmp_path):
        tckpt.save_checkpoint(str(tmp_path), 1, {"a": torch.ones(3)})
        with pytest.raises(ValueError, match="1 arrays"):
            tckpt.restore_checkpoint(str(tmp_path),
                                     {"a": torch.ones(3), "b": torch.ones(1)})


# ---------------------------------------------------------------------------
# Straggler monitor
# ---------------------------------------------------------------------------

STREAMS = {
    "sustained_slowdown": [0.10] * 20 + [0.20] * 10,
    "transients": [0.2 if i % 10 == 0 else 0.1 for i in range(40)],
    "ramp": [0.1 * (1 + 0.05 * i) for i in range(40)],
}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_straggler_monitor_trips_as_the_reference(stream):
    jev, tev = [], []
    jmon = jstraggler.StragglerMonitor(a_t=1.3, o_t=5, on_straggler=jev.append)
    tmon = StragglerMonitor(a_t=1.3, o_t=5, on_straggler=tev.append)
    trips = [(tmon.report(t), jmon.report(t)) for t in STREAMS[stream]]
    assert [a for a, _ in trips] == [b for _, b in trips]
    assert [dataclasses.astuple(e) for e in tev] == \
        [dataclasses.astuple(e) for e in jev]
    if stream == "sustained_slowdown":
        assert tev
    if stream == "transients":
        assert not any(a for a, _ in trips)


# ---------------------------------------------------------------------------
# Legacy experiment shims
# ---------------------------------------------------------------------------

def _sim_json(res) -> str:
    return json.dumps(dataclasses.asdict(res.sim), sort_keys=True)


def test_harness_run_experiment_bit_for_bit():
    kw = dict(duration_ms=20_000.0, seed=3, jitter_std=0.01)
    jcluster, jwls, jbg = jsnapshot("S2", n_iterations=30)
    tcluster, twls, tbg = tsnapshot("S2", n_iterations=30)
    want = jharness.run_experiment("metronome", jcluster, jwls,
                                   JSimConfig(**kw), background=jbg,
                                   traffic_changes=[(5_000.0, "vgg16-ft",
                                                     1.4)])
    got = tharness.run_experiment("metronome", tcluster, twls,
                                  TSimConfig(fluid_backend="python",
                                             device="cpu", **kw),
                                  background=tbg,
                                  traffic_changes=[(5_000.0, "vgg16-ft",
                                                    1.4)])
    assert _sim_json(got) == _sim_json(want)
    assert (got.accepted, got.rejected, got.scheduler, got.placements) == \
        (want.accepted, want.rejected, want.scheduler, want.placements)


def test_harness_run_trace_experiment_bit_for_bit():
    from repro.configs.metronome_testbed import trace_scenario as jtrace
    from repro_torch.configs.metronome_testbed import trace_scenario as ttr
    jspecs = jgenerate_trace(JFLEET, duration_s=600, total_gpus=13,
                             target_load=0.85, seed=1,
                             job_duration_range_s=(60, 120))[:5]
    tspecs = ttrace.specs_from_records(dataclasses.asdict(s)
                                       for s in jspecs)
    kw = dict(duration_ms=60_000, seed=0, jitter_std=0.01)
    jcl, jwls, _, jevs = jtrace(jspecs, open_ended=True,
                                name="t").materialize()
    tcl, twls, _, tevs = ttr(tspecs, open_ended=True, name="t").materialize()
    want = jharness.run_trace_experiment("metronome", jcl, jwls,
                                         JSimConfig(**kw), events=jevs)
    got = tharness.run_trace_experiment(
        "metronome", tcl, twls,
        TSimConfig(fluid_backend="python", device="cpu", **kw), events=tevs)
    assert _sim_json(got) == _sim_json(want)
    assert (got.accepted, got.rejected, got.placements) == \
        (want.accepted, want.rejected, want.placements)


def test_harness_default_config_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cluster, wls, _ = tsnapshot("S2", n_iterations=2)
    with pytest.raises(RuntimeError, match="is_available"):
        tharness.run_experiment("metronome", cluster, wls)


# ---------------------------------------------------------------------------
# Training entry point
# ---------------------------------------------------------------------------

def test_train_entry_point_runs_checkpoints_and_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    ttrain.main(["--arch", "recurrentgemma-2b", "--device", "cpu",
                 "--steps", "3", "--log-every", "1",
                 "--ckpt-dir", ckpt, "--ckpt-every", "2"])
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in out[:3]] == [
        ["step", "0"], ["step", "1"], ["step", "2"]]
    assert "ms/it" in out[0] and out[-1] == "done"
    assert tckpt.latest_step(ckpt) == 3
    res = ttrain.train(tconfigs.get_smoke_config(ARCH), steps=5, batch=8,
                       seq=128, lr=3e-3, ckpt_dir=ckpt, device="cpu")
    assert res.start == 3 and len(res.losses) == 2
    assert all(np.isfinite(res.losses))
    assert tckpt.latest_step(ckpt) == 5
