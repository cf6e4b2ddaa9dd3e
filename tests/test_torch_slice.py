"""The port's main path end to end against the JAX package's.

``experiment.run`` on a trace scenario drives every module of the slice:
trace -> scheduler (geometry, scoring, rotation, framework) -> controller
-> simulator -> fluid -> results.  Two small traces go through both
packages, built from the same records (``specs_from_records``):

  * a 3-job ``generate_trace`` on the paper's star testbed;
  * a 40-job production trace on the 2-leaf x 2-host 2:1 leaf-spine fabric
    with the dynamic-throughput benchmark's departures and synthetic
    events (the ``experiment`` phase of ``chip_smoke.py`` at a small size).

With the float64 ``python`` fluid backend the results JSON must equal the
reference's exactly.  With ``kernel`` on the CPU (the fill kernel's plain
float32 version) against the reference's float32 ``jnp``: the same
finished jobs, ``total_completion_ms`` within 1e-6 relative, and sampled
in-loop rates within 1e-6 of ``fill_python``.  Also: the port imports
nothing of JAX, of the reference, or of networkx, and a default
``SimConfig`` refuses to run on a machine without a card.
"""
import ast
import dataclasses
import importlib.util
import math
import sys
from pathlib import Path

import pytest
import torch

from benchmarks import bench_dynamic_throughput as rbench
from repro.configs import metronome_testbed as rtb
from repro.core import experiment as rexp
from repro.core import fluid as rfluid
from repro.core import simulator as rsim
from repro.core import trace as rtrace
from repro_torch.configs import metronome_testbed as tb
from repro_torch.core import experiment, simulator, trace

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def _star_traces():
    ref = rtrace.generate_trace(rtb.MODEL_FLEET, duration_s=3 * 1800.0,
                                seed=1)[:3]
    port = trace.specs_from_records(dataclasses.asdict(s) for s in ref)
    return ref, port


def _fabric_traces(n_jobs=40):
    ref = rtrace.generate_production_trace(rtb.MODEL_FLEET, n_jobs=n_jobs,
                                           seed=7, **rbench.TRACE_KW)
    port = trace.specs_from_records(dataclasses.asdict(s) for s in ref)
    return ref, port


def _run_star(backend_ref, backend_port, event_loop="array"):
    ref_tr, port_tr = _star_traces()
    kw = dict(duration_ms=60_000.0, seed=3, jitter_std=0.01,
              event_loop=event_loop)
    want = rexp.run(rtb.trace_scenario(ref_tr, time_scale=0.01),
                    rexp.Policy("metronome"),
                    rsim.SimConfig(fluid_backend=backend_ref, **kw))
    got = experiment.run(tb.trace_scenario(port_tr, time_scale=0.01),
                         experiment.Policy("metronome"),
                         simulator.SimConfig(fluid_backend=backend_port,
                                             device="cpu", **kw))
    return want, got


def _run_fabric(backend_ref, backend_port):
    ref_tr, port_tr = _fabric_traces()
    ref_scen = rexp.Scenario.trace(
        name="dynamic-trace", build=rbench.DynamicTraceBuild(tuple(ref_tr)))
    ref_cfg = rsim.SimConfig(duration_ms=cs.horizon_ms(port_tr) + 1_000.0,
                             seed=3, jitter_std=0.01,
                             fluid_backend=backend_ref)
    with cs.audited_engines() as ref_engines:
        want = rexp.run(ref_scen, rexp.Policy(
            "metronome", skip_third_stage=True, rotation_joint=False),
            ref_cfg)
    port_cfg = cs.dynamic_sim_config(port_tr, fluid_backend=backend_port,
                                     device="cpu")
    assert port_cfg.duration_ms == ref_cfg.duration_ms
    with cs.audited_engines() as engines:
        got = experiment.run(cs.dynamic_trace_scenario(port_tr),
                             cs.DYNAMIC_POLICY, port_cfg)
    assert len(engines) == 1 and not ref_engines
    return want, got, engines[0]


def test_traces_from_records_are_identical():
    for ref, port in (_star_traces(), _fabric_traces()):
        assert [dataclasses.asdict(s) for s in port] == \
            [dataclasses.asdict(s) for s in ref]
    # the port's own generator draws the same numpy streams
    _, port = _fabric_traces()
    assert port == trace.generate_production_trace(
        tb.MODEL_FLEET, n_jobs=40, seed=7, **cs.TRACE_KW)


@pytest.mark.parametrize("runner", [_run_star, _run_fabric],
                         ids=["star-3", "fabric-40"])
def test_python_backend_results_json_equal(runner):
    out = runner("python", "python")
    want, got = out[0], out[1]
    assert got.to_json_dict() == want.to_json_dict()


def test_legacy_event_loop_results_json_equal():
    """The legacy per-object loop is carried over verbatim too: with the
    python backend it replays the reference's legacy loop exactly."""
    want, got = _run_star("python", "python", event_loop="legacy")
    assert got.to_json_dict() == want.to_json_dict()


def _finished(res):
    return {j for j, t in res.sim.finish_times_ms.items()
            if not math.isnan(t)}


@pytest.mark.parametrize("runner", [_run_star, _run_fabric],
                         ids=["star-3", "fabric-40"])
def test_kernel_on_cpu_tracks_the_reference_jnp(runner):
    out = runner("jnp", "kernel")
    want, got = out[0], out[1]
    assert got.accepted == want.accepted
    assert got.placements == want.placements
    assert _finished(got) == _finished(want)
    assert got.sim.total_completion_ms == pytest.approx(
        want.sim.total_completion_ms, rel=1e-6)
    if len(out) == 3:
        engine = out[2]
        assert engine.samples
        assert cs.audit_error(engine) <= 1e-6
        # the same samples against the reference's own oracle
        for d, p, c, r in engine.samples:
            gold = rfluid.fill_python(d, p, c)
            assert len(gold) == 0 or float(abs(r - gold).max()) <= 1e-6


def test_port_imports_no_jax_reference_or_networkx():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    banned = ("jax", "jaxlib", "repro", "networkx")
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in banned, f"{path}: imports {name}"


def test_default_sim_config_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        simulator.SimConfig()
    with pytest.raises(RuntimeError, match="is_available"):
        simulator.SimConfig(fluid_backend="torch")
    simulator.SimConfig(fluid_backend="python")  # host oracle: no device
    simulator.SimConfig(device="cpu")


def test_defaults_fill_on_the_card():
    fields = {f.name: f.default
              for f in dataclasses.fields(simulator.SimConfig)}
    assert fields["fluid_backend"] == "kernel"
    assert fields["device"] == "cuda"
