"""The rest of the paper's evaluation in the port against the JAX package's.

``chip_smoke.py``'s ``paper_figures`` phase runs the grids of the
reference's ``bench_param_variation`` (Figs. 11, 12), ``bench_thresholds``
(Figs. 14, 15), ``bench_persistence`` (Table VI), ``bench_rotation`` (J1,
the F4 planner), ``bench_fabric`` and ``bench_sched_time`` (Fig. 16) on
the card.  Here, on the CPU:

  (a) each bench's grid, captured with ``common.run_sweep`` stubbed (and
      ``bench_thresholds.run_cell`` for Fig. 15), against chip_smoke's
      constants and scenarios: the same clusters, latencies, jobs,
      background flows and events, policies and ``SimConfig`` fields;
      72 cells in all;
  (b) both packages live at a small size (20 iterations a job, 60 s),
      with the float64 ``python`` fluid backend: results JSON equal for
      Fig. 11 with and without its duty change, Fig. 12 at each tau on
      S4, Fig. 14 on S2 at every (A_T, O_T), Fig. 15 at gaps 35 and 0
      (both fleets restored after), Table VI's long window on S1 (the
      scenario's own ``SimConfig``), J1 joint and per-link with the worst
      planning score equal, the fabric at 1:1, 2:1 and 4:1 under every
      scheduler;
  (c) F4's per-link ``solve_link`` loop and ``joint_solve`` (numpy) give
      the reference's shifts and scores;
  (d) Fig. 16: each plugin places the new job on the reference's nodes
      beside 0-4 jobs, and the recalculation gives the reference's
      offsets;
  (e) the ``kernel`` backend on the CPU against the reference's float32
      ``jnp`` on the fabric at 4:1 and Fig. 12 at tau 80
      (``tests/test_torch_slice.py``'s bars);
  and the Default and Diktyo plugins' least-allocated score on nodes
  whose cpu, mem and gpu fractions differ.
"""
import dataclasses
import importlib.util
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from benchmarks import (bench_fabric, bench_param_variation,
                        bench_persistence, bench_rotation, bench_sched_time,
                        bench_thresholds)
from benchmarks import common as bench_common
from repro.configs import metronome_testbed as rtb
from repro.core import baselines as rbase
from repro.core import cluster as rcluster
from repro.core import contention as rcont
from repro.core import experiment as rexp
from repro.core import framework as rfw
from repro.core import rotation as rrot
from repro.core import simulator as rsim
from repro.core import topology as rtopo
from repro.core import workload as rwl
from repro_torch.configs import metronome_testbed as tb
from repro_torch.core import baselines, cluster, contention, experiment
from repro_torch.core import framework, rotation, simulator, topology
from repro_torch.core import workload

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


cs = _load("chip_smoke_figures", ROOT / "chip_smoke.py")

SIM_KW = dict(duration_ms=60_000.0, seed=3, jitter_std=0.01)
N_ITER = 20


def _cfg(ref: bool, backend="python", **kw):
    kw = dict(SIM_KW, **kw)
    if ref:
        return rsim.SimConfig(fluid_backend=backend, **kw)
    return simulator.SimConfig(fluid_backend=backend, device="cpu", **kw)


def _json_equal(ref_scn, port_scn, scheduler, ref_cfg=None, port_cfg=None,
                **policy_kw):
    want = rexp.run(ref_scn, rexp.Policy(scheduler, **policy_kw),
                    ref_cfg if ref_cfg is not None else _cfg(True))
    got = experiment.run(port_scn, experiment.Policy(scheduler, **policy_kw),
                         port_cfg if port_cfg is not None else _cfg(False))
    assert got.to_json_dict() == want.to_json_dict()
    return got


def _facts(data):
    """What a scenario's build gives, as plain values: the cluster's nodes,
    latencies and fabric, the jobs, background flows and events."""
    cl, wls = data[0], list(data[1])
    bg = list(data[2]) if len(data) > 2 else []
    events = list(data[3]) if len(data) > 3 else []
    topo = cl.topology
    return dict(
        nodes=[(n, dataclasses.asdict(cl.nodes[n].capacity),
                cl.nodes[n].bw_gbps, cl.nodes[n].allocatable_gbps)
               for n in cl.node_names],
        latency=np.asarray(cl.latency).tolist(),
        leaves=dict(topo.leaf_of),
        uplinks={k: dataclasses.asdict(v) for k, v in topo.uplinks.items()},
        workloads=[(wl.name, [dataclasses.asdict(j) for j in wl.jobs])
                   for wl in wls],
        background=[dataclasses.asdict(b) for b in bg],
        events=[(type(e).__name__, dataclasses.asdict(e)) for e in events])


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


def _builds(scenarios):
    """Each dataclass build's fields (the two packages' build classes
    differ, so their instances never compare equal)."""
    return [(type(s.build).__name__, dataclasses.asdict(s.build))
            for s in scenarios]


@pytest.fixture()
def grids(monkeypatch):
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    return {g.name: g for g in cs.paper_figure_grids()}


# ------------------------------------------------- (a) the grids' settings
class _Result:
    """Whatever a bench reads off a result: one job of each priority,
    every time 1."""

    high_priority = low_priority = ["j"]
    sim = SimpleNamespace(time_per_1000_iters_s={"j": 1.0},
                          avg_bw_utilization=0.0, readjustments=0,
                          finish_times_ms={}, total_completion_ms=1.0,
                          uplink_utilization={})

    def mean_s_per_1000(self, jobs=None):
        return 1.0

    def mean_jct_ms(self, jobs=None):
        return 1.0


class _Captured:
    """What a bench passed to ``common.run_sweep``."""

    def __init__(self, scenarios, policies, cfg):
        self.scenarios, self.policies, self.cfg = scenarios, policies, cfg

    def get(self, *_):
        return _Result()


def _capture(monkeypatch, bench):
    calls = []

    def run_sweep(scenarios, policies, cfg=None, *, origin, strict=True):
        calls.append(_Captured(list(scenarios), list(policies), cfg))
        return calls[-1]

    monkeypatch.setattr(bench_common, "SMOKE", False)
    monkeypatch.setattr(bench_common, "run_sweep", run_sweep)
    monkeypatch.setattr(bench, "emit", lambda *a, **kw: None)
    return calls


def test_fig11_and_fig12_grids_are_bench_param_variation(monkeypatch,
                                                         grids):
    calls = _capture(monkeypatch, bench_param_variation)
    bench_param_variation.run()
    fig11, fig12 = calls[:2], calls[2:]
    assert len(fig11) == 2 and len(fig12) == 2
    ref = [s for c in fig11 for s in c.scenarios]
    port = grids["fig11"].scenarios
    assert [s.name for s in port] == [s.name for s in ref]
    for r, p in zip(ref, port):
        assert _facts(p.build()) == _facts(r.build())
    assert _facts(port[1].build())["events"]  # the duty change is there
    ref = [s for c in fig12 for s in c.scenarios]
    port = grids["fig12"].scenarios
    assert [s.name for s in port] == [s.name for s in ref]
    for r, p in zip(ref, port):
        assert _facts(p.build()) == _facts(r.build())
    for c in calls:
        assert _policies(c.policies) == _policies(grids["fig11"].policies)
        _same_config(c.cfg, cs.BENCH_SIM)
    assert _policies(bench_param_variation.POLICIES) == _policies(
        grids["fig12"].policies)


def test_fig14_and_fig15_grids_are_bench_thresholds(monkeypatch, grids):
    calls = _capture(monkeypatch, bench_thresholds)
    cells = []
    fleet = {m: dict(v) for m, v in rtb.MODEL_FLEET.items()}

    def run_cell(scn, pol, cfg):  # S3 built under the bench's fleet
        cells.append((scn, pol, cfg, _facts(scn.build())))
        return _Result()

    monkeypatch.setattr(bench_thresholds, "run_cell", run_cell)
    bench_thresholds.run()
    assert rtb.MODEL_FLEET == fleet  # the bench restored its entry
    fig14 = grids["fig14"]
    assert [c.scenarios[0].name for c in calls] == \
        [s.name for s in fig14.scenarios] == list(cs.THRESHOLD_SNAPSHOTS)
    assert _builds(fig14.scenarios) == _builds([c.scenarios[0]
                                                for c in calls])
    for c in calls:
        assert _policies(c.policies) == _policies(fig14.policies)
        _same_config(c.cfg, cs.THRESHOLD_SIM)
    assert [p.name for p in fig14.policies][0] == "metronome-a_t=1.05-o_t=3"
    fig15 = grids["fig15"]
    assert len(cells) == len(fig15.scenarios) == len(cs.FIG15_GAPS)
    for (scn, pol, cfg, facts), port, gap in zip(cells, fig15.scenarios,
                                                 cs.FIG15_GAPS):
        assert (scn.name, port.name) == ("S3", f"S3-gap{gap:g}")
        assert _facts(port.build()) == facts
        assert _policies([pol]) == _policies(fig15.policies)
        _same_config(cfg, fig15.sim)
    assert tb.MODEL_FLEET == {m: dict(v) for m, v in fleet.items()}


def test_table6_grid_is_bench_persistence(monkeypatch, grids):
    calls = _capture(monkeypatch, bench_persistence)
    bench_persistence.run()
    assert all(c.cfg is None for c in calls)
    assert _policies(calls[0].policies) == _policies(
        grids["tableVI"].policies)
    ref = [s for c in calls for s in c.scenarios]
    port = grids["tableVI"].scenarios
    assert grids["tableVI"].sim is None
    assert [s.name for s in port] == [s.name for s in ref]
    assert _builds(port) == _builds(ref)
    for r, p in zip(ref, port):
        for f in dataclasses.fields(r.sim_config):
            if f.name != "fluid_backend":
                assert getattr(p.sim_config, f.name) == \
                    getattr(r.sim_config, f.name), f.name


def test_table6_twin_runs_each_scenario_s_config_on_the_cpu(monkeypatch):
    """A scenario's own ``SimConfig`` wins over ``sweep``'s None, so the
    grid must hand each one the twin's device, not the card's."""
    own = simulator.SimConfig(device="cpu", **SIM_KW)
    own.device = "cuda"  # the card's, as the phase builds it
    scn = tb.snapshot_scenario("S2", n_iterations=N_ITER, sim_config=own)
    grid = cs.Grid("t", (scn,), (experiment.Policy("default"),), None)
    with cs.metered_runs({"cpu": cs.Recorder(keep=0)}, []) as meters:
        out = grid.run("cpu")
    assert not out.errors
    assert list(meters) == [("S2", "default", "cpu")]
    assert scn.sim_config.device == "cuda"  # the grid's own is untouched


def test_rotation_grid_and_planner_are_bench_rotation(monkeypatch, grids):
    calls = _capture(monkeypatch, bench_rotation)
    scheduled, solves = [], []
    schedule = bench_rotation._schedule

    def recorded_schedule(sid, joint, n_iterations):
        scheduled.append((sid, joint, n_iterations))
        out = schedule(sid, joint, n_iterations)
        if sid == "F4":  # the planner's timed loops follow: record them
            monkeypatch.setattr(bench_rotation.rotation, "solve_link",
                                solve_link)
            monkeypatch.setattr(bench_rotation.rotation, "joint_solve",
                                joint_solve)
        return out

    def solve_link(view, registry, lid, **kw):
        solves.append(("loop", lid, kw))
        return None

    def joint_solve(view, registry, links, **kw):
        solves.append(("batched", tuple(links), kw))
        return SimpleNamespace(score=100.0)

    monkeypatch.setattr(bench_rotation, "_schedule", recorded_schedule)
    bench_rotation.run()
    (call,) = calls
    (scn,) = call.scenarios
    assert (scn.name, scn.build.n_iterations) == ("J1",
                                                  cs.ROTATION_ITERATIONS)
    assert _builds(grids["J1"].scenarios) == _builds([scn])
    assert _policies(call.policies) == _policies(cs.ROTATION_POLICIES)
    _same_config(call.cfg, cs.ROTATION_SIM)
    assert scheduled == [("J1", True, cs.ROTATION_ITERATIONS),
                         ("J1", False, cs.ROTATION_ITERATIONS),
                         ("F4", True, cs.ROTATION_ITERATIONS)]
    batched = [kw for kind, _, kw in solves if kind == "batched"]
    loop = [kw for kind, _, kw in solves if kind == "loop"]
    assert len(batched) == cs.PLANNER_REPS + 1  # a warm-up, then the reps
    assert all(kw == dict(mode="fast", backend="kernel") for kw in batched)
    assert len(loop) == 2 * len(batched)  # F4's two contended uplinks
    assert all(kw == dict(mode="fast") for kw in loop)


def test_fabric_grid_is_bench_fabric(monkeypatch, grids):
    calls = _capture(monkeypatch, bench_fabric)
    bench_fabric.run()
    ratios, snaps = calls[:-1], calls[-1]
    assert len(ratios) == len(cs.FABRIC_RATIOS)
    port = grids["fabric"].scenarios
    ref = [c.scenarios[0] for c in ratios]
    assert [s.name for s in port] == [s.name for s in ref]
    for r, p in zip(ref, port):
        assert _facts(p.build()) == _facts(r.build())
    for c in ratios:
        assert _policies(c.policies) == _policies(grids["fabric"].policies)
        assert [p.scheduler for p in c.policies] == \
            list(bench_common.SCHEDULER_NAMES)
        _same_config(c.cfg, cs.FABRIC_SIM)
    assert [s.name for s in snaps.scenarios] == \
        [s.name for s in grids["fabric_snapshots"].scenarios]
    assert _builds(grids["fabric_snapshots"].scenarios) == \
        _builds(snaps.scenarios)
    assert _policies(snaps.policies) == _policies(
        grids["fabric_snapshots"].policies)
    _same_config(snaps.cfg, cs.FABRIC_SIM)
    assert bench_fabric.RATIOS == cs.FABRIC_RATIOS


def test_fig16_steps_are_bench_sched_time(monkeypatch):
    jobs, workloads, rows, clusters = [], [], [], []
    make_job, wl_cls, make_cluster = (bench_sched_time.make_job,
                                      bench_sched_time.Workload,
                                      bench_sched_time._cluster)

    def recorded_job(name, **kw):
        jobs.append(dict(kw, name=name))
        return make_job(name, **kw)

    def recorded_workload(name, jobs):
        workloads.append(name)
        return wl_cls(name=name, jobs=jobs)

    def recorded_cluster():
        clusters.append(make_cluster())
        return clusters[-1]

    monkeypatch.setattr(bench_common, "SMOKE", False)
    monkeypatch.setattr(bench_sched_time, "make_job", recorded_job)
    monkeypatch.setattr(bench_sched_time, "Workload", recorded_workload)
    monkeypatch.setattr(bench_sched_time, "_cluster", recorded_cluster)
    monkeypatch.setattr(bench_sched_time, "emit",
                        lambda name, us, derived: rows.append(name))
    bench_sched_time.run()
    want = _facts((cs._sched_cluster(), []))
    assert all(_facts((c, [])) == want for c in clusters)
    assert len(clusters) == 4 * len(cs.SCHED_PERIODS)  # 3 plugins + recalc
    periods = {j["name"]: j["period_ms"] for j in jobs}
    assert [periods[f"bg-{i}"] for i in range(len(cs.SCHED_PERIODS))] == \
        list(cs.SCHED_PERIODS)
    assert periods["new"] == cs.SCHED_NEW_PERIOD
    for j in jobs:
        assert {k: j[k] for k in cs.SCHED_JOB} == cs.SCHED_JOB
    assert max(int(w.split("-")[1]) for w in workloads
               if w.startswith("new-")) + 1 == cs.SCHED_REPS
    want_rows = [f"fig16_sched_{p}_{n}jobs" for n in range(5)
                 for p in cs.SCHED_PLUGINS]
    assert [r for r in rows if r.startswith("fig16_sched")] == want_rows
    assert [r for r in rows if r.startswith("fig16_recalc")] == \
        [f"fig16_recalc_{n + 1}jobs" for n in range(5)]


def test_the_phase_runs_72_cells(grids):
    cells = {name: len(g.scenarios) * len(g.policies)
             for name, g in grids.items()}
    assert sum(cells.values()) == 72
    assert cells == dict(fig11=6, fig12=18, fig14=18, fig15=6, tableVI=6,
                         J1=2, fabric=12, fabric_snapshots=4)
    assert all(g.twin and g.cut is None for g in grids.values())
    keys = [(s.name, p.name) for g in grids.values() for s in g.scenarios
            for p in g.policies]
    assert len(set(keys)) == len(keys) == 72  # one meter key a cell


# ----------------------------------------------- (b) results JSON equal
FIG11_CASES = [(label, s) for label, _ in cs.FIG11_LABELS
               for s in cs.FIGURE_SCHEDULERS]


@pytest.mark.parametrize("label,scheduler", FIG11_CASES,
                         ids=[f"{a}-{b}" for a, b in FIG11_CASES])
def test_fig11_results_json_equal(monkeypatch, label, scheduler):
    monkeypatch.setattr(bench_common, "SMOKE", False)
    halved = dict(cs.FIG11_LABELS)[label]
    ref = bench_param_variation._s1_scenario(label, halved, N_ITER)
    port = experiment.Scenario(f"S1-{label}",
                               cs.BatchChangeBuild(halved, N_ITER))
    got = _json_equal(ref, port, scheduler)
    assert got.scenario == f"S1-{label}"


FIG12_CASES = [(tau, s) for tau in cs.FIG12_TAUS for s in cs.FIGURE_SCHEDULERS]


@pytest.mark.parametrize("tau,scheduler", FIG12_CASES,
                         ids=[f"tau{int(a)}-{b}" for a, b in FIG12_CASES])
def test_fig12_results_json_equal(tau, scheduler):
    ref = bench_param_variation._tau_scenario("S4", tau, N_ITER)
    port = experiment.Scenario(f"S4-tau{int(tau)}",
                               cs.TauBuild("S4", tau, N_ITER))
    _json_equal(ref, port, scheduler)


THRESHOLDS = [(a, o) for o in cs.THRESHOLD_O_T for a in cs.THRESHOLD_A_T]


@pytest.mark.parametrize("a_t,o_t", THRESHOLDS)
def test_fig14_thresholds_results_json_equal(a_t, o_t):
    want = rexp.run(rtb.snapshot_scenario("S2", n_iterations=N_ITER),
                    bench_thresholds._threshold_policy(a_t, o_t),
                    _cfg(True, jitter_std=0.02))
    got = experiment.run(tb.snapshot_scenario("S2", n_iterations=N_ITER),
                         cs.threshold_policy(a_t, o_t),
                         _cfg(False, jitter_std=0.02))
    assert got.policy == f"metronome-a_t={a_t}-o_t={o_t}"
    assert got.to_json_dict() == want.to_json_dict()


@pytest.mark.parametrize("gap", [35.0, 0.0])
def test_fig15_gap_results_json_equal(gap):
    ref_fleet = {m: dict(v) for m, v in rtb.MODEL_FLEET.items()}
    port_fleet = {m: dict(v) for m, v in tb.MODEL_FLEET.items()}
    period = cs.fig15_period(gap)
    saved = rtb.MODEL_FLEET[cs.FIG15_MODEL]
    rtb.MODEL_FLEET[cs.FIG15_MODEL] = dict(saved, period_ms=period)
    try:
        want = rexp.run(dataclasses.replace(
            rtb.snapshot_scenario("S3", n_iterations=N_ITER),
            name=f"S3-gap{gap:g}"),
            bench_thresholds._threshold_policy(*cs.FIG15_POLICY),
            _cfg(True, jitter_std=0.02))
    finally:
        rtb.MODEL_FLEET[cs.FIG15_MODEL] = saved
    got = experiment.run(
        experiment.Scenario(f"S3-gap{gap:g}", cs.GapBuild(gap, N_ITER)),
        cs.threshold_policy(*cs.FIG15_POLICY), _cfg(False, jitter_std=0.02))
    assert rtb.MODEL_FLEET == ref_fleet and tb.MODEL_FLEET == port_fleet
    assert got.to_json_dict() == want.to_json_dict()
    # the low-priority WideResNet ran at the gap's period
    assert got.sim.time_per_1000_iters_s["wrn101-ft"] >= period


def test_fig15_gap_changes_the_result():
    """Six cells that share S3's job names differ in one period only:
    a cache keyed on names would hand gap 0 gap 35's result."""
    out = {gap: experiment.run(
        experiment.Scenario("S3", cs.GapBuild(gap, N_ITER)),
        cs.threshold_policy(*cs.FIG15_POLICY),
        _cfg(False, jitter_std=0.02)).to_json_dict() for gap in (35.0, 0.0)}
    assert out[35.0]["sim"] != out[0.0]["sim"]


def test_table6_long_window_results_json_equal():
    """S1 at the bench's smoke long window, through the scenario's own
    ``SimConfig`` (``run`` is given None, as ``bench_persistence`` does)."""
    kw = dict(duration_ms=30_000.0, seed=3, jitter_std=0.01)
    ref = dataclasses.replace(rtb.snapshot_scenario(
        "S1", n_iterations=60, sim_config=rsim.SimConfig(
            fluid_backend="python", **kw)), name="S1-long")
    port = dataclasses.replace(tb.snapshot_scenario(
        "S1", n_iterations=60, sim_config=simulator.SimConfig(
            fluid_backend="python", device="cpu", **kw)), name="S1-long")
    want = rexp.run(ref, rexp.Policy("metronome"))
    got = experiment.run(port, experiment.Policy("metronome"))
    assert got.to_json_dict() == want.to_json_dict()


@pytest.mark.parametrize("policy", cs.ROTATION_POLICIES,
                         ids=[p.name for p in cs.ROTATION_POLICIES])
def test_j1_rotation_results_json_and_worst_score_equal(policy):
    ref_pol = next(p for p in bench_rotation.J1_POLICIES
                   if p.name == policy.name)
    want = rexp.run(rtb.snapshot_scenario("J1", n_iterations=N_ITER),
                    ref_pol, _cfg(True, jitter_std=0.02))
    got = experiment.run(tb.snapshot_scenario("J1", n_iterations=N_ITER),
                         policy, _cfg(False, jitter_std=0.02))
    assert got.to_json_dict() == want.to_json_dict()
    c, fw, ctrl, _ = bench_rotation._schedule("J1", policy.rotation_joint,
                                              N_ITER)
    want_score = bench_rotation._worst_planning_score(c, fw.registry, ctrl)
    c, fw, ctrl = cs.schedule_snapshot("J1", N_ITER, policy.rotation_joint)
    ctrl.run_offline_recalculation(fw.registry, c)
    assert cs.worst_planning_score(c, fw.registry, ctrl) == want_score
    assert (want_score == 100.0) == policy.rotation_joint


FABRIC_CASES = [(r, s) for r in cs.FABRIC_RATIOS
                for s in cs.FABRIC_SCHEDULERS]


@pytest.mark.parametrize("ratio,scheduler", FABRIC_CASES,
                         ids=[f"{a:g}to1-{b}" for a, b in FABRIC_CASES])
def test_fabric_results_json_equal(monkeypatch, ratio, scheduler):
    monkeypatch.setattr(bench_common, "SMOKE", True)  # 25 iterations a job
    ref = bench_fabric._ratio_scenario(ratio)
    port = experiment.Scenario(f"F2@{ratio:g}to1",
                               cs.FabricRatioBuild(ratio, 25))
    _json_equal(ref, port, scheduler)


# -------------------------------------------------- (c) the F4 planner
@pytest.fixture(scope="module")
def f4_views():
    """F4 scheduled by each package as ``bench_rotation`` does: its link
    view, registry and contended uplinks."""
    ref = bench_rotation._schedule("F4", True, cs.ROTATION_ITERATIONS)
    port = cs.schedule_snapshot("F4", cs.ROTATION_ITERATIONS)
    port[2].run_offline_recalculation(port[1].registry, port[0])
    out = []
    for (c, fw), cont, topo in (((ref[0], ref[1]), rcont, rtopo),
                                ((port[0], port[1]), contention, topology)):
        view = cont.LinkView.from_registry(c, fw.registry)
        out.append((view, fw.registry,
                    [l for l in view.planning_links() if topo.is_uplink(l)]))
    return out


def test_f4_per_link_loop_is_the_reference_s(f4_views):
    (rv, rreg, rlinks), (pv, preg, plinks) = f4_views
    assert plinks == rlinks and len(plinks) == 2
    for lid in plinks:
        want = rrot.solve_link(rv, rreg, lid, mode="fast")
        got = rotation.solve_link(pv, preg, lid, mode="fast")
        assert got[0] == want[0]
        assert (got[1] is None) == (want[1] is None)
        if want[1] is not None:
            assert got[1].jobs == want[1].jobs
            assert np.array_equal(got[1].shifts_slots, want[1].shifts_slots)
            assert got[1].base_ms == want[1].base_ms


def test_f4_joint_solve_is_the_reference_s(f4_views):
    (rv, rreg, rlinks), (pv, preg, plinks) = f4_views
    want = rrot.joint_solve(rv, rreg, rlinks, mode="fast", backend="numpy")
    got = rotation.joint_solve(pv, preg, plinks, mode="fast",
                               backend="numpy")
    assert got.jobs == want.jobs
    assert np.array_equal(got.shifts, want.shifts)
    assert got.score == want.score and got.feasible == want.feasible
    # the kernel backend's plain version on the CPU chooses the same
    kernel = rotation.joint_solve(pv, preg, plinks, mode="fast",
                                  backend="kernel", device="cpu")
    assert np.array_equal(kernel.shifts, want.shifts)
    assert kernel.score == pytest.approx(want.score, abs=cs.SCORE_TOL)


# ------------------------------------------------------------ (d) Fig. 16
def _ref_framework(plugin: str, n_jobs: int):
    """``bench_sched_time``'s steps with the reference's classes."""
    from repro.core.controller import StopAndWaitController
    from repro.core.scheduler import MetronomePlugin
    cl = rcluster.Cluster([rcluster.Node(
        f"n{i}", rcluster.Resources(**cs.SCHED_NODE),
        bw_gbps=cs.SCHED_BW_GBPS) for i in range(cs.SCHED_NODES)])
    ctrl = StopAndWaitController()
    plugins = {"metronome": lambda: MetronomePlugin(controller=ctrl),
               "default": rbase.DefaultPlugin,
               "diktyo": rbase.DiktyoPlugin}
    fw = rfw.SchedulingFramework(cl, plugins[plugin]())
    for i in range(n_jobs):
        j = rwl.make_job(f"bg-{i}", period_ms=cs.SCHED_PERIODS[i],
                         **cs.SCHED_JOB)
        fw.schedule_workload(rwl.Workload(name=j.name, jobs=[j]))
    return cl, ctrl, fw


FIG16_CASES = [(p, n) for n in range(len(cs.SCHED_PERIODS))
               for p in cs.SCHED_PLUGINS]


@pytest.mark.parametrize("plugin,n_existing", FIG16_CASES,
                         ids=[f"{a}-{b}jobs" for a, b in FIG16_CASES])
def test_fig16_placement_is_the_reference_s(plugin, n_existing):
    _, _, fw = _ref_framework(plugin, n_existing)
    new = rwl.make_job("new", period_ms=cs.SCHED_NEW_PERIOD, **cs.SCHED_JOB)
    assert fw.schedule_workload(rwl.Workload(name="new-0", jobs=[new]))
    want = [t.node for t in new.tasks]
    row = cs.sched_placement(plugin, n_existing)
    assert row["nodes"] == want
    assert (row["plugin"], row["existing_jobs"]) == (plugin, n_existing)
    assert row["ms_per_pod"] == pytest.approx(row["host_us"] / 2e3)


@pytest.mark.parametrize("n_jobs", range(1, len(cs.SCHED_PERIODS) + 1))
def test_fig16_recalculation_is_the_reference_s(n_jobs):
    cl, ctrl, fw = _ref_framework("metronome", n_jobs)
    ctrl.pending_recalc = list(ctrl.links.keys())
    ctrl.run_offline_recalculation(fw.registry, cl)
    want = {f"bg-{i}": ctrl.job_offset_ms(f"bg-{i}") for i in range(n_jobs)}
    row = cs.sched_recalculation(n_jobs)
    assert row["offsets_ms"] == want
    assert row["jobs"] == n_jobs and row["host_s"] >= 0.0


# --------------------------------- (e) the fill kernel's twin on the CPU
def _finished(res):
    return {j for j, t in res.sim.finish_times_ms.items()
            if not math.isnan(t)}


KERNEL_CASES = ([("fabric", s) for s in cs.FABRIC_SCHEDULERS]
                + [("fig12", s) for s in cs.FIGURE_SCHEDULERS])


@pytest.mark.parametrize("grid,scheduler", KERNEL_CASES,
                         ids=[f"{a}-{b}" for a, b in KERNEL_CASES])
def test_kernel_on_cpu_tracks_the_reference_jnp(monkeypatch, grid,
                                                scheduler):
    if grid == "fabric":
        monkeypatch.setattr(bench_common, "SMOKE", True)
        ref = bench_fabric._ratio_scenario(4.0)
        port = experiment.Scenario("F2@4to1", cs.FabricRatioBuild(4.0, 25))
    else:
        ref = bench_param_variation._tau_scenario("S4", 80.0, N_ITER)
        port = experiment.Scenario("S4-tau80", cs.TauBuild("S4", 80.0,
                                                           N_ITER))
    want = rexp.run(ref, rexp.Policy(scheduler), _cfg(True, "jnp"))
    got = experiment.run(port, experiment.Policy(scheduler),
                         _cfg(False, "kernel"))
    assert got.accepted == want.accepted
    assert got.rejected == want.rejected
    assert got.placements == want.placements
    assert _finished(got) == _finished(want)
    assert got.sim.total_completion_ms == pytest.approx(
        want.sim.total_completion_ms, rel=1e-6)


# ------------------------- the least-allocated score on uneven fractions
# capacities and allocations whose free cpu, mem and gpu fractions differ
# on every node, so a mean of the three and a min of them disagree
UNEVEN_NODES = (("a", dict(cpu=64, mem=256, gpu=8), dict(cpu=8, mem=192,
                                                         gpu=2)),
                ("b", dict(cpu=32, mem=512, gpu=4), dict(cpu=24, mem=64,
                                                         gpu=0)),
                ("c", dict(cpu=16, mem=128, gpu=8), dict(cpu=0, mem=32,
                                                         gpu=6)))
UNEVEN_POD = dict(cpu=4, mem=16, gpu=1)


def _uneven_cluster(mod):
    nodes = []
    for name, cap, used in UNEVEN_NODES:
        node = mod.Node(name, mod.Resources(**cap), bw_gbps=25.0)
        node.allocate(f"pre-{name}", mod.Resources(**used), 0.0)
        nodes.append(node)
    return mod.Cluster(nodes)


@pytest.mark.parametrize("plugin", ["DefaultPlugin", "DiktyoPlugin"])
def test_least_allocated_score_on_uneven_fractions(plugin):
    """Diktyo falls back to the same mean when the pod has no placed
    dependency."""
    ref_cl, port_cl = _uneven_cluster(rcluster), _uneven_cluster(cluster)
    ref_pod = rwl.make_job("p", n_tasks=1, period_ms=100.0, duty=0.3,
                           bw_gbps=5.0, resources=rcluster.Resources(
                               **UNEVEN_POD)).tasks[0]
    port_pod = workload.make_job("p", n_tasks=1, period_ms=100.0, duty=0.3,
                                 bw_gbps=5.0, resources=cluster.Resources(
                                     **UNEVEN_POD)).tasks[0]
    ref_plugin = getattr(rbase, plugin)()
    port_plugin = getattr(baselines, plugin)()
    for name, cap, used in UNEVEN_NODES:
        free = [(cap[a] - used[a] - UNEVEN_POD[a]) / cap[a]
                for a in ("cpu", "mem", "gpu")]
        assert min(free) < np.mean(free)  # the case tells mean from min
        want = ref_plugin.score(rfw.ScheduleContext(), ref_cl, ref_pod,
                                name, rfw.TaskRegistry())
        got = port_plugin.score(framework.ScheduleContext(), port_cl,
                                port_pod, name, framework.TaskRegistry())
        assert got == want
        scale = 100.0 if plugin == "DefaultPlugin" else 1.0
        assert got == pytest.approx(scale * np.mean(free))


@pytest.mark.parametrize("scheduler", ["default", "diktyo"])
def test_uneven_cluster_placement_is_the_reference_s(scheduler):
    """A four-pod job on the uneven nodes: every pod where the
    reference's plugin puts it."""
    plugins = {"default": "DefaultPlugin", "diktyo": "DiktyoPlugin"}
    placed = []
    for cl_mod, wl_mod, fw_mod, base in (
            (rcluster, rwl, rfw, rbase),
            (cluster, workload, framework, baselines)):
        cl = _uneven_cluster(cl_mod)
        fw = fw_mod.SchedulingFramework(cl,
                                        getattr(base, plugins[scheduler])())
        job = wl_mod.make_job("j", n_tasks=4, period_ms=100.0, duty=0.3,
                              bw_gbps=5.0, spread=0,
                              resources=cl_mod.Resources(**UNEVEN_POD))
        assert fw.schedule_workload(wl_mod.Workload(name="j", jobs=[job]))
        placed.append([t.node for t in job.tasks])
    assert placed[0] == placed[1]
