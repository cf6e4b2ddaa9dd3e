"""The port's examples (``examples_torch/``) against the JAX package's
(``examples/``), and the runtime package's exports.

On ``--device cpu`` the examples' simulations run the ``'python'`` fluid
backend, so what they print equals the reference examples' output bit for
bit.  quickstart's vectorised cell runs the plain PyTorch fill there,
held to the reference's jnp cell at 1e-6 relative (the float32 fill's bar
against the float64 oracle).
"""
import importlib.util
import sys
from pathlib import Path

import pytest
import torch

import repro.runtime as jruntime
import repro_torch.runtime as truntime
from repro.core.experiment import Policy as JPolicy
from repro.core.experiment import Scenario as JScenario
from repro.core.experiment import sweep as jsweep
from repro.core.simulator import SimConfig as JSimConfig
from repro_torch.runtime import (CommGate, IterationReporter, TrainState,
                                 auto_microbatches, build_serve_step,
                                 build_train_step, make_train_state_specs)
from repro_torch.runtime import comm_gate, steps

ROOT = Path(__file__).resolve().parents[1]


def _load(path: Path):
    name = f"_example_{path.parent.name}_{path.stem}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_output(name, argv, monkeypatch, capsys) -> str:
    mod = _load(ROOT / "examples" / f"{name}.py")
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    mod.main()
    return capsys.readouterr().out


def test_quickstart_matches_the_reference(monkeypatch, capsys):
    want = _reference_output("quickstart", [], monkeypatch, capsys)
    port = _load(ROOT / "examples_torch" / "quickstart.py")
    grid, rv = port.main(["--device", "cpu"])
    got = capsys.readouterr().out
    want_lines, got_lines = want.splitlines(), got.splitlines()
    assert got_lines[:-1] == want_lines[:-1]
    assert got_lines[-1].startswith("metronome-fluid=torch: lo s/1000 = ")
    assert want_lines[-1].startswith("metronome-fluid=jnp: lo s/1000 = ")
    ref = _load(ROOT / "examples" / "quickstart.py")
    scenario = JScenario(name="two-job-contention", build=ref.build)
    vec = JPolicy("metronome", sim_backend="jnp")
    jrv = jsweep([scenario], [vec], JSimConfig(
        duration_ms=40_000.0, seed=0, jitter_std=0.01)).get(scenario.name,
                                                             vec.name)
    for group in ("high_priority", "low_priority"):
        a = rv.mean_s_per_1000(getattr(rv, group))
        b = jrv.mean_s_per_1000(getattr(jrv, group))
        assert a == pytest.approx(b, rel=1e-6), group
    assert rv.sim.avg_bw_utilization == pytest.approx(
        jrv.sim.avg_bw_utilization, rel=1e-6)


@pytest.mark.parametrize("argv", [["--jobs", "3"],
                                  ["--jobs", "3", "--fabric", "2.0"]],
                         ids=["star", "fabric"])
def test_cluster_sim_matches_the_reference(argv, monkeypatch, capsys):
    want = _reference_output("cluster_sim", argv, monkeypatch, capsys)
    port = _load(ROOT / "examples_torch" / "cluster_sim.py")
    port.main([*argv, "--device", "cpu"])
    assert capsys.readouterr().out == want


def test_serve_decode_runs_on_the_cpu(capsys):
    port = _load(ROOT / "examples_torch" / "serve_decode.py")
    toks = port.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
                      "--gen", "5"])
    assert tuple(toks.shape) == (2, 5)
    assert int(toks.min()) >= 0 and int(toks.max()) < 512
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill 2x8: ")
    assert out[1].startswith("decoded 4 steps x batch 2: ")
    assert out[2].startswith("sample token ids: [")


@pytest.mark.parametrize("name,argv", [
    ("quickstart", []), ("cluster_sim", ["--jobs", "1"]),
    ("serve_decode", ["--gen", "2"]), ("train_lm", ["--steps", "1"])])
def test_examples_default_to_the_card(name, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = _load(ROOT / "examples_torch" / f"{name}.py")
    with pytest.raises(RuntimeError, match="is_available"):
        port.main(argv)


def test_runtime_exports_the_reference_names():
    """``from repro_torch.runtime import ...`` works for every name the
    JAX package's ``repro.runtime`` exports."""
    assert set(truntime.__all__) == set(jruntime.__all__)
    assert (TrainState, auto_microbatches, build_serve_step,
            build_train_step, make_train_state_specs) == (
                steps.TrainState, steps.auto_microbatches,
                steps.build_serve_step, steps.build_train_step,
                steps.make_train_state_specs)
    assert (CommGate, IterationReporter) == (comm_gate.CommGate,
                                             comm_gate.IterationReporter)
    for name in truntime.__all__:
        assert getattr(truntime, name) is not None, name


def test_train_lm_follows_the_reference_from_its_weights(tmp_path, capsys):
    """``examples_torch/train_lm.py`` (its tiny preset, bf16) for 3 steps
    from the JAX init's weights against the reference's train step on the
    same batches: the first loss within the dense family's train-step bar
    (1e-4 relative, ``tests/test_torch_dense.py``), all three within its
    bf16 bar (2e-2)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.data import SyntheticLM as JSyntheticLM
    from repro.optim import AdamWConfig as JAdamWConfig
    from repro.runtime import steps as jsteps
    from repro_torch.models import params_from_jax

    ref = _load(ROOT / "examples" / "train_lm.py")
    port = _load(ROOT / "examples_torch" / "train_lm.py")
    jcfg, tcfg = ref.PRESETS["tiny"], port.PRESETS["tiny"]
    assert jcfg.name == tcfg.name and jcfg.n_layers == tcfg.n_layers
    steps = 3
    jopt = JAdamWConfig(lr=3e-3, warmup_steps=20, total_steps=steps)
    jstate, _ = jsteps.init_train_state(jcfg, jopt, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jstate.params)
    params = params_from_jax(tree, tcfg, "cpu")
    got = port.main(["--steps", str(steps), "--device", "cpu",
                     "--ckpt-dir", str(tmp_path)], init_params=params)
    step = jax.jit(jsteps.build_train_step(jcfg, jopt, n_micro=2))
    ds = JSyntheticLM(jcfg.vocab, 64, 8, seed=0)
    want = []
    for i in range(steps):
        batch = {k: jnp.asarray(v) for k, v in ds.batch_at(i).items()}
        jstate, m = step(jstate, batch)
        want.append(float(m["loss"]))
    assert len(got) == steps
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_allclose(got, want, rtol=2e-2)
    out = capsys.readouterr().out
    assert "params=" in out and out.rstrip().endswith("~ln(vocab)")
