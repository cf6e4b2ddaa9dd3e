"""The paper's evaluation grid in the port against the JAX package's.

The paper's claims come from running Metronome against the registry's
baselines through ``experiment.sweep`` on the testbed's scenarios.  Here
the same grids go through both packages at a small size (20 iterations a
job, 60 s; the Fig. 10 trace at ``bench_tct``'s smoke size, 4 jobs and
120 s):

  * every scheduler of the registry and the ideal run on the snapshots
    S1-S5, F2, F4, J1, the dynamic D1, D2 and the fault R1, R2, with the
    float64 ``python`` fluid backend: results JSON equal;
  * the Metronome ablations of ``bench_ablation``, ``bench_dynamic``,
    ``bench_dynamic_throughput`` and ``examples/cluster_sim.py`` on S2,
    F4, J1 and D1: results JSON equal;
  * the ``kernel`` backend on the CPU (the fill kernel's plain float32
    version) against the reference's float32 ``jnp`` for every scheduler
    on S2, F4 and the Fig. 10 trace: the same accepted jobs and
    placements, the same finished jobs and ``total_completion_ms`` within
    1e-6 relative (``tests/test_torch_slice.py``'s bars);
  * ``sweep(workers=2)`` in thread and process mode against the
    reference's serial sweep;
  * ``chip_smoke.py``'s grid settings against the reference benches' own;
  * ``core/results``: ``SweepResult.save``/``load``, the BENCH writers and
    every validator, on the committed ``BENCH_*.json`` files (read, never
    written) and on copies with one field broken.
"""
import copy
import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmarks import bench_ablation, bench_dynamic, bench_snapshots
from benchmarks import bench_dynamic_throughput, bench_tct
from benchmarks import common as bench_common
from repro.configs import metronome_testbed as rtb
from repro.core import experiment as rexp
from repro.core import results as rres
from repro.core import simulator as rsim
from repro.core import trace as rtrace
from repro_torch.configs import metronome_testbed as tb
from repro_torch.core import experiment, results, simulator, trace

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


cs = _load("chip_smoke", ROOT / "chip_smoke.py")

REF = SimpleNamespace(tb=rtb, exp=rexp, sim=rsim, trace=rtrace, cfg={})
PORT = SimpleNamespace(tb=tb, exp=experiment, sim=simulator, trace=trace,
                       cfg={"device": "cpu"})

SIM_KW = dict(duration_ms=60_000.0, seed=3, jitter_std=0.01)
N_ITER = 20
SCHEDULERS = experiment.scheduler_names()
SCENARIOS = (tb.SNAPSHOTS + tb.FABRIC_SNAPSHOTS + tb.JOINT_SNAPSHOTS
             + tb.DYNAMIC_SNAPSHOTS + tb.FAULT_SNAPSHOTS)
# bench_tct at its smoke size
FIG10_JOBS, FIG10_SIM_KW = 4, dict(duration_ms=120_000, seed=0,
                                   jitter_std=0.01)

# the Metronome ablations the benches and examples run
ABLATIONS = {
    "wo_stage3": dict(skip_third_stage=True, rotation_mode="compact",
                      label="wo_stage3"),  # bench_ablation
    "noreconf": dict(reconfigure=False,
                     label="metronome_noreconf"),  # bench_dynamic
    "legacyrot": dict(rotation_joint=False,
                      label="metronome"),  # cluster_sim --no-joint
    "wo3": dict(skip_third_stage=True),
    "compact": dict(rotation_mode="compact"),
    "optimal": dict(rotation_mode="optimal"),
    "legacyrot-wo3": dict(skip_third_stage=True,
                          rotation_joint=False),  # bench_dynamic_throughput
}


def _scenario(pkg, sid, n_iterations=N_ITER):
    if sid in tb.DYNAMIC_SNAPSHOTS:
        return pkg.tb.dynamic_scenario(sid, n_iterations=n_iterations)
    if sid in tb.FAULT_SNAPSHOTS:
        return pkg.tb.fault_scenario(sid, n_iterations=n_iterations)
    return pkg.tb.snapshot_scenario(sid, n_iterations=n_iterations)


def _cfg(pkg, backend="python", **kw):
    return pkg.sim.SimConfig(fluid_backend=backend,
                             **dict(SIM_KW, **kw), **pkg.cfg)


def _grids():
    production = cs.generate_production_trace(cs.MODEL_FLEET, n_jobs=3,
                                              seed=7, **cs.TRACE_KW)
    return {g.name: g for g in cs.paper_grids(production)}


def _fig10(pkg, open_ended=True):
    specs = pkg.trace.generate_trace(
        pkg.tb.MODEL_FLEET, **cs.FIG10_TRACE_KW)[:FIG10_JOBS]
    name = "gavel-trace" if open_ended else "gavel-trace-capped"
    return pkg.tb.trace_scenario(specs, open_ended=open_ended, name=name)


# --------------------------------------------------------------- (a) grid
@pytest.mark.parametrize("sid", SCENARIOS)
@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_every_scheduler_results_json_equal(scheduler, sid):
    want = rexp.run(_scenario(REF, sid), rexp.Policy(scheduler), _cfg(REF))
    got = experiment.run(_scenario(PORT, sid), experiment.Policy(scheduler),
                         _cfg(PORT))
    assert got.scheduler == scheduler
    assert got.to_json_dict() == want.to_json_dict()


def test_the_registry_is_the_reference_s():
    assert SCHEDULERS == rexp.scheduler_names()
    assert SCHEDULERS == cs.PAPER_SCHEDULERS
    # the ideal run is not a registered plugin in either package
    for pkg in (REF, PORT):
        with pytest.raises(ValueError, match="ideal"):
            pkg.exp.register_scheduler("ideal", lambda policy: None)


# ----------------------------------------------------------- (b) ablations
@pytest.mark.parametrize("sid", ["S2", "F4", "J1", "D1"])
@pytest.mark.parametrize("ablation", list(ABLATIONS) + ["wo_monitor"])
def test_ablation_results_json_equal(ablation, sid):
    kw = ABLATIONS.get(ablation, dict(label="wo_monitor"))
    cfg_kw = dict(monitor=False) if ablation == "wo_monitor" else {}
    want = rexp.run(_scenario(REF, sid), rexp.Policy("metronome", **kw),
                    _cfg(REF, **cfg_kw))
    got = experiment.run(_scenario(PORT, sid),
                         experiment.Policy("metronome", **kw),
                         _cfg(PORT, **cfg_kw))
    assert got.policy == experiment.Policy("metronome", **kw).name
    assert got.to_json_dict() == want.to_json_dict()


# ------------------------------------------- (c) the fill kernel's twin
def _finished(res):
    return {j for j, t in res.sim.finish_times_ms.items()
            if not math.isnan(t)}


KERNEL_CASES = ([(sid, s) for sid in ("S2", "F4") for s in SCHEDULERS]
                + [("fig10", s) for s in SCHEDULERS])


@pytest.mark.parametrize("sid,scheduler", KERNEL_CASES,
                         ids=[f"{a}-{b}" for a, b in KERNEL_CASES])
def test_kernel_on_cpu_tracks_the_reference_jnp(sid, scheduler):
    if sid == "fig10":  # the ideal run takes the capped companion
        open_ended = scheduler != "ideal"
        scenarios = (_fig10(REF, open_ended), _fig10(PORT, open_ended))
        cfgs = (REF.sim.SimConfig(fluid_backend="jnp", **FIG10_SIM_KW),
                PORT.sim.SimConfig(fluid_backend="kernel", device="cpu",
                                   **FIG10_SIM_KW))
    else:
        scenarios = (_scenario(REF, sid), _scenario(PORT, sid))
        cfgs = (_cfg(REF, "jnp"), _cfg(PORT, "kernel"))
    want = rexp.run(scenarios[0], rexp.Policy(scheduler), cfgs[0])
    got = experiment.run(scenarios[1], experiment.Policy(scheduler),
                         cfgs[1])
    assert got.accepted == want.accepted
    assert got.rejected == want.rejected
    assert got.placements == want.placements
    assert _finished(got) == _finished(want)
    assert got.sim.total_completion_ms == pytest.approx(
        want.sim.total_completion_ms, rel=1e-6)


def test_fig10_trace_is_the_reference_s():
    ref = rtrace.generate_trace(rtb.MODEL_FLEET, **cs.FIG10_TRACE_KW)
    port = trace.generate_trace(tb.MODEL_FLEET, **cs.FIG10_TRACE_KW)
    assert [dataclasses.asdict(s) for s in port] == \
        [dataclasses.asdict(s) for s in ref]
    assert trace.cluster_load(port[:cs.FIG10_JOBS], 13, 1800) == \
        rtrace.cluster_load(ref[:cs.FIG10_JOBS], 13, 1800)


# -------------------------------------------------------------- (d) sweep
GRID = (("S2", "F4"), ("metronome", "default", "exclusive", "ideal"))


def _grid(pkg, **kw):
    return pkg.exp.sweep([_scenario(pkg, sid) for sid in GRID[0]],
                         [pkg.exp.Policy(s) for s in GRID[1]], _cfg(pkg),
                         **kw)


@pytest.fixture(scope="module")
def reference_sweep():
    return _grid(REF)


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_parallel_sweep_equals_the_reference_serial_one(mode,
                                                        reference_sweep):
    got = _grid(PORT, workers=2, mode=mode)
    assert not got.errors
    assert [(c.scenario, c.policy) for c in got.cells] == \
        [(c.scenario, c.policy) for c in reference_sweep.cells]
    assert got.to_json_dict() == reference_sweep.to_json_dict()


def test_sweep_isolates_a_failing_cell_as_the_reference_does():
    bad = [("S2", "nosuch"), ("S2", "default")]
    sweeps = [pkg.exp.sweep([_scenario(pkg, "S2")],
                            [pkg.exp.Policy(s) for _, s in bad], _cfg(pkg))
              for pkg in (REF, PORT)]
    for sw in sweeps:
        assert [c.policy for c in sw.errors] == ["nosuch"]
        assert "unknown scheduler 'nosuch'" in sw.errors[0].error
        with pytest.raises(RuntimeError, match="nosuch"):
            sw.get("S2", "nosuch")
    want, got = (sw.cell("S2", "default").to_json_dict() for sw in sweeps)
    assert got == want


# ---------------------------------------------- (e) the grid's settings
class _Stop(Exception):
    pass


class _Captured:
    """What a bench passed to ``common.run_sweep``; reading a result
    ends the bench."""

    def __init__(self, scenarios, policies, cfg):
        self.scenarios, self.policies, self.cfg = scenarios, policies, cfg

    def get(self, *_):
        raise _Stop


def _capture(monkeypatch, bench):
    calls = []

    def run_sweep(scenarios, policies, cfg=None, *, origin, strict=True):
        calls.append(_Captured(list(scenarios), list(policies), cfg))
        return calls[-1]

    monkeypatch.setattr(bench_common, "SMOKE", False)
    monkeypatch.setattr(bench_common, "run_sweep", run_sweep)
    with pytest.raises(_Stop):
        bench.run()
    return calls


def _same_config(ref_cfg, port_sim: dict):
    """The bench's SimConfig is the port's from ``port_sim`` in every
    field but the fluid backend and the device."""
    port = simulator.SimConfig(fluid_backend="kernel", device="cpu",
                               **port_sim)
    for f in dataclasses.fields(ref_cfg):
        if f.name != "fluid_backend":
            assert getattr(port, f.name) == getattr(ref_cfg, f.name), f.name


def _policies(pols):
    return [dataclasses.asdict(p) for p in pols]


def test_snapshot_grid_is_bench_snapshots(monkeypatch):
    (call,) = _capture(monkeypatch, bench_snapshots)
    (scn,) = call.scenarios
    assert scn.name == "S1"
    assert scn.build.n_iterations == cs.BENCH_ITERATIONS
    _same_config(call.cfg, cs.BENCH_SIM)
    _same_config(bench_common.BENCH_CFG, cs.BENCH_SIM)
    assert set(bench_common.SCHEDULER_NAMES) <= set(cs.PAPER_SCHEDULERS)
    assert _policies(call.policies) == _policies(
        rexp.Policy(s) for s in bench_common.SCHEDULER_NAMES)
    assert cs.GRID_SNAPSHOTS == rtb.SNAPSHOTS + rtb.FABRIC_SNAPSHOTS \
        + rtb.JOINT_SNAPSHOTS


def test_ablation_grid_is_bench_ablation(monkeypatch):
    full, mon = _capture(monkeypatch, bench_ablation)
    assert [s.name for s in full.scenarios] == ["S1"]
    assert full.scenarios[0].build.n_iterations == cs.BENCH_ITERATIONS
    assert _policies(full.policies) == _policies(cs.ABLATIONS)
    assert _policies(bench_ablation.ABLATIONS) == _policies(cs.ABLATIONS)
    _same_config(full.cfg, cs.ABLATION_SIM)
    assert mon.cfg.monitor is False


def test_dynamic_grid_is_bench_dynamic(monkeypatch):
    (call,) = _capture(monkeypatch, bench_dynamic)
    (scn,) = call.scenarios
    amp = cs.DYNAMIC_AMPLITUDES[0]
    assert dataclasses.asdict(scn.build) == dataclasses.asdict(
        tb.dynamic_scenario("D1", amplitude=amp,
                            **cs.DYNAMIC_SCENARIO_KW).build)
    assert bench_dynamic.AMPLITUDES == cs.DYNAMIC_AMPLITUDES
    assert rtb.DYNAMIC_SNAPSHOTS == tb.DYNAMIC_SNAPSHOTS
    assert _policies(call.policies) == _policies(cs.DYNAMIC_GRID_POLICIES)
    _same_config(call.cfg, cs.DYNAMIC_SIM)
    # the amplitude in the port's scenario name keeps cells apart
    grid = _grids()["dynamic"]
    names = [s.name for s in grid.scenarios]
    assert len(set(names)) == len(names) == 6 and names[0] == "D1-a0.2"


def test_fig10_grid_is_bench_tct(monkeypatch):
    opened, capped = _capture(monkeypatch, bench_tct)
    assert [p.scheduler for p in opened.policies] == \
        list(cs.FIG10_SCHEDULERS)
    assert [p.scheduler for p in capped.policies] == ["ideal"]
    _same_config(opened.cfg, cs.FIG10_SIM)
    _same_config(capped.cfg, cs.FIG10_SIM)
    grids = _grids()
    for call, grid in ((opened, grids["fig10"]),
                       (capped, grids["fig10_ideal"])):
        (ref_scn,) = call.scenarios
        (scn,) = grid.scenarios
        assert scn.name == ref_scn.name and scn.mode == ref_scn.mode
        assert scn.build.open_ended == ref_scn.build.open_ended
        assert [dataclasses.asdict(s) for s in scn.build.trace] == \
            [dataclasses.asdict(s) for s in ref_scn.build.trace]
        assert len(scn.build.trace) == cs.FIG10_JOBS


def test_fault_and_production_grids_follow_their_sources():
    robust = _load("torch_robustness_settings",
                   ROOT / "tests" / "test_torch_robustness.py")
    assert cs.FAULT_KW == robust.FAULT_KW
    assert cs.FAULT_SIM == robust.SIM_KW
    assert cs.FAULT_SCHEDULERS + ("ideal",) == cs.PAPER_SCHEDULERS
    assert cs.TRACE_KW == bench_dynamic_throughput.TRACE_KW
    grids = _grids()
    assert [g.twin for g in grids.values()].count(False) == 1
    assert not grids["production"].twin
    assert "ideal" not in [p.scheduler for p in cs.PRODUCTION_POLICIES]
    cells = sum(len(g.scenarios) * len(g.policies) for g in grids.values())
    assert cells == 40 + 10 + 18 + 8 + 3 + 1 + 4


# ---------------------------------------------------------- core/results
BENCH_FILES = {
    "BENCH_trace_throughput.json": "validate_trace_throughput_dict",
    "BENCH_dynamic_throughput.json": "validate_dynamic_throughput_dict",
    "BENCH_robustness.json": "validate_robustness_dict",
    "benchmarks/baselines/BENCH_dynamic_throughput.smoke.json":
        "validate_dynamic_throughput_dict",
    "benchmarks/baselines/BENCH_robustness.smoke.json":
        "validate_robustness_dict",
    "benchmarks/baselines/BENCH_sched_time.smoke.json":
        "validate_timing_dict",
    "benchmarks/baselines/BENCH_sweep.smoke.json": "validate_bench_dict",
}


def _read(name):
    return json.loads((ROOT / name).read_text())


def _rows(doc):
    return doc["sweeps"] if "sweeps" in doc else doc["rows"]


def _break_version(doc):
    doc["schema_version"] = 2


def _break_kind_or_cells(doc):
    if "kind" in doc:
        doc["kind"] = "sweep"
    else:  # a sweep payload has no kind: its first sweep loses its cells
        doc["sweeps"][0]["cells"] = []


def _drop_first_key(doc):
    row = _rows(doc)[0]
    del row[next(iter(row))]


def _number_to_string(doc):
    row = _rows(doc)[-1]
    key = next(k for k, v in row.items()
               if isinstance(v, (int, float)) and not isinstance(v, bool))
    row[key] = "1.0"


def _row_not_an_object(doc):
    _rows(doc)[0] = [1, 2]


def _empty_rows(doc):
    doc["sweeps" if "sweeps" in doc else "rows"] = []


def _rows_not_a_list(doc):
    doc["sweeps" if "sweeps" in doc else "rows"] = {"a": 1}


BREAKERS = (None, _break_version, _break_kind_or_cells, _drop_first_key,
            _number_to_string, _row_not_an_object, _empty_rows,
            _rows_not_a_list)


@pytest.mark.parametrize("breaker", BREAKERS,
                         ids=lambda b: "intact" if b is None else b.__name__)
@pytest.mark.parametrize("name", list(BENCH_FILES))
def test_validators_return_the_reference_s_problems(name, breaker):
    doc = _read(name)
    if breaker is not None:
        breaker(doc)
    validator = BENCH_FILES[name]
    want = getattr(rres, validator)(copy.deepcopy(doc))
    got = getattr(results, validator)(copy.deepcopy(doc))
    assert got == want
    assert (got == []) == (breaker is None)


def test_validators_refuse_a_non_object_as_the_reference_does():
    for validator in set(BENCH_FILES.values()):
        assert getattr(results, validator)([1]) == \
            getattr(rres, validator)([1]) == ["top level is not an object"]


ROW_WRITERS = {
    "to_trace_throughput_dict": "BENCH_trace_throughput.json",
    "to_dynamic_throughput_dict": "BENCH_dynamic_throughput.json",
    "to_robustness_dict": "BENCH_robustness.json",
    "to_timing_dict": "benchmarks/baselines/BENCH_sched_time.smoke.json",
}


@pytest.mark.parametrize("writer", list(ROW_WRITERS))
def test_row_writers_equal_the_reference_s(writer):
    doc = _read(ROW_WRITERS[writer])
    rows = copy.deepcopy(doc["rows"])
    got = getattr(results, writer)(rows, smoke=doc["smoke"])
    assert got == getattr(rres, writer)(copy.deepcopy(rows),
                                        smoke=doc["smoke"])
    assert got == doc  # the committed file is the writer's own output
    assert rows == doc["rows"]


def test_committed_sweeps_round_trip_as_the_reference_s():
    doc = _read("benchmarks/baselines/BENCH_sweep.smoke.json")
    got = [results.SweepResult.from_json_dict(s) for s in doc["sweeps"]]
    want = [rres.SweepResult.from_json_dict(s) for s in doc["sweeps"]]
    assert [s.to_json_dict() for s in got] == \
        [s.to_json_dict() for s in want]
    # the compact payload drops the durations, so a reload's mean_iter_ms
    # is null in both packages; every other field comes back as written
    out = results.to_bench_dict(got, smoke=True)
    assert out == rres.to_bench_dict(want, smoke=True)
    for sweep in out["sweeps"] + doc["sweeps"]:
        for cell in sweep["cells"]:
            cell["result"]["sim"].pop("mean_iter_ms")
    assert out == doc


@pytest.mark.parametrize("durations", [True, False],
                         ids=["durations", "compact"])
def test_sweep_save_load_and_bench_dict_equal_the_reference_s(
        tmp_path, reference_sweep, durations):
    got = _grid(PORT)
    got.meta.update(origin="paper_grid")
    reference_sweep = copy.deepcopy(reference_sweep)
    reference_sweep.meta.update(origin="paper_grid")
    ref_path, port_path = tmp_path / "ref.json", tmp_path / "port.json"
    reference_sweep.save(str(ref_path), include_durations=durations)
    got.save(str(port_path), include_durations=durations)
    assert port_path.read_text() == ref_path.read_text()
    loaded = results.SweepResult.load(str(port_path))
    ref_loaded = rres.SweepResult.load(str(ref_path))
    assert loaded.to_json_dict() == ref_loaded.to_json_dict()
    if durations:  # a compact save drops what mean_iter_ms derives from
        assert loaded.to_json_dict() == got.to_json_dict()
    doc = results.to_bench_dict([got, loaded], include_durations=durations)
    assert doc == rres.to_bench_dict([reference_sweep, ref_loaded],
                                     include_durations=durations)
    assert results.validate_bench_dict(doc) == [] == \
        rres.validate_bench_dict(doc)
