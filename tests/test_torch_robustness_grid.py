"""The graceful-degradation bench in the port against the JAX package's.

``chip_smoke.py``'s ``robustness`` phase runs the grid of the reference's
``benchmarks/bench_robustness.py`` on the card: every control-plane read of
bandwidth through a ``TelemetryChannel``, ``metronome`` against
``metronome-robust`` (hysteresis and demand reconciliation) on the noise,
staleness, failure and trace axes, seeds 3-5, 120 runs, each twinned on
the CPU by a pool of spawned processes.  Here, on the CPU:

  (a) the bench's grid, captured with ``experiment.run`` stubbed inside
      it (and ``record_robustness_row`` and ``emit``), against
      chip_smoke's 120 runs: the same builds, policies and ``SimConfig``
      fields (the channel's too) but for the backend and device;
  (b) chip_smoke's rows from the same stub results as the bench's
      ``_sweep_axis``, field for field, a NaN seed and an all-NaN column
      among them, through both packages' ``to_robustness_dict``;
  (c) both packages live at the bench's smoke size with the float64
      ``python`` fluid backend: results JSON equal under both policies at
      each axis's x = 0 and largest x on D1, D2 and R1, and on a 3-job
      trace at noise 0.2; the hysteresis suppresses a reconfiguration and
      a reconciliation is adopted, in both alike;
  (d) the ``kernel`` backend on the CPU (the fill's plain float32
      version) against the reference's float32 ``jnp`` on R1 at 8 cycles
      under ``metronome-robust`` (``tests/test_torch_slice.py``'s bars);
  (e) the twin pool: two small cells on 2 spawned workers equal their
      serial twin, and ``run_grids`` takes a grid's twin from the pool;
  and the corpus and experiment phases' fill launches read as their own,
  so that the experiment's check fails when its run launches nothing.
"""
import dataclasses
import importlib
import importlib.util
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from benchmarks import bench_robustness
from benchmarks import common as bench_common
from repro.configs import metronome_testbed as rtb
from repro.core import experiment as rexp
from repro.core import results as rresults
from repro.core import simulator as rsim
from repro.core import trace as rtrace
from repro_torch.configs import metronome_testbed as tb
from repro_torch.core import experiment, results, simulator, telemetry
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


cs = _load("chip_smoke_robustness", ROOT / "chip_smoke.py")

# the bench's smoke settings (its ``common.pick`` second values)
SMOKE = dict(ROBUST_SIM_MS=15_000.0,
             ROBUST_DYNAMIC_KW=dict(n_iterations=25, t_on_ms=4_000.0,
                                    t_off_ms=12_000.0),
             ROBUST_FAULT_KW=dict(n_iterations=25, start_ms=3_000.0,
                                  period_ms=1_500.0, down_ms=300.0),
             ROBUST_TRACE_KW=dict(cs.ROBUST_TRACE_KW, duration_s=240.0),
             ROBUST_TRACE_JOBS=3, ROBUST_TRACE_MS=45_000.0)


def _policies(pols):
    return [dataclasses.asdict(p) for p in pols]


def _build(scn):
    """A scenario's build as plain values (the two packages' build
    classes differ, so their instances never compare equal)."""
    return type(scn.build).__name__, dataclasses.asdict(scn.build)


def _config(cfg, skip=("fluid_backend", "device")):
    """A ``SimConfig``'s fields as plain values, the channel's too."""
    return {f.name: dataclasses.asdict(getattr(cfg, f.name))
            if f.name == "telemetry" else getattr(cfg, f.name)
            for f in dataclasses.fields(cfg) if f.name not in skip}


def _runs():
    """chip_smoke's runs in the bench's order (axis, policy, x, seed),
    each as (key, scenario, policy)."""
    grids = {g.name: g for g in cs.robustness_grids(cs.robust_trace())}
    out = []
    for axis, sid, xs in cs.ROBUST_AXES:
        grid = grids[f"{axis}_{sid}"]
        scns = {s.name: s for s in grid.scenarios}
        for pol in grid.policies:
            for x in xs:
                for seed in cs.ROBUST_SEEDS:
                    out.append(((axis, sid, x, pol.name, seed),
                                scns[cs.robust_name(axis, sid, x, seed)],
                                pol))
    return out


def _capture(monkeypatch, results_in_order=None):
    """Run the bench at its full settings with ``experiment.run`` stubbed:
    the (scenario, policy, config) of each call, and the rows it records
    (the results handed back in call order, else a stub)."""
    calls, rows = [], []

    def run(scn, policy, cfg):
        calls.append((scn, policy, cfg))
        if results_in_order is None:
            return _Result(len(calls), nan_seed=False)
        return results_in_order[len(calls) - 1]

    monkeypatch.setattr(bench_common, "SMOKE", False)
    monkeypatch.setattr(bench_robustness.experiment, "run", run)
    monkeypatch.setattr(bench_robustness, "record_robustness_row",
                        lambda **row: rows.append(row))
    monkeypatch.setattr(bench_robustness, "emit", lambda *a, **kw: None)
    bench_robustness.run()
    return calls, rows


# ------------------------------------------------- (a) the grid's settings
def test_the_phase_runs_the_bench_s_120_runs(monkeypatch):
    calls, _ = _capture(monkeypatch)
    runs = _runs()
    assert len(calls) == len(runs) == 120
    for (scn, pol, cfg), (key, port, port_pol) in zip(calls, runs):
        axis, sid, x, _, seed = key
        assert scn.name == sid and scn.mode == port.mode, key
        assert port.name == cs.robust_name(axis, sid, x, seed)
        assert _build(port) == _build(scn), key
        assert _policies([port_pol]) == _policies([pol]), key
        assert cfg.seed == seed
        assert _config(port.sim_config) == _config(cfg), key
    # the trace axis runs the bench's 8 jobs
    trace = [s for s, _, _ in calls if s.name == cs.ROBUST_TRACE_NAME][0]
    assert len(trace.build.trace) == cs.ROBUST_TRACE_JOBS == 8
    keys = {(s.name, p.name) for _, s, p in runs}
    assert len(keys) == 120  # one meter key a run


def test_the_grids_are_frozen_and_pickle():
    import pickle
    grids = cs.robustness_grids(cs.robust_trace())
    assert [g.name for g in grids] == ["noise_D1", "noise_D2",
                                       "staleness_D2", "failure_R1",
                                       f"trace_{cs.ROBUST_TRACE_NAME}"]
    for g in grids:
        assert g.sim is None and g.twin and g.cut is None
        assert pickle.loads(pickle.dumps(g)) == g
        for s in g.scenarios:
            assert cs._frozen(s) and cs._frozen(s.build)
            assert cs._frozen(s.sim_config.telemetry)
        assert all(cs._frozen(p) for p in g.policies)
    assert sum(len(g.scenarios) * len(g.policies) for g in grids) == 120


def test_the_policies_and_channel_are_the_bench_s():
    assert _policies(cs.ROBUST_POLICIES) == _policies(
        bench_robustness.POLICIES)
    assert [p.name for p in cs.ROBUST_POLICIES] == ["metronome",
                                                    "metronome-robust"]
    assert (cs.SAMPLE_PERIOD_MS, cs.AXIS_BASE_NOISE) == (
        bench_robustness.SAMPLE_PERIOD_MS, bench_robustness.AXIS_BASE_NOISE)
    assert (cs.NOISE_GRID, cs.STALENESS_GRID, cs.FLAP_GRID,
            cs.TRACE_NOISE_GRID) == (
        bench_robustness.NOISE_GRID, bench_robustness.STALENESS_GRID,
        bench_robustness.FLAP_GRID, bench_robustness.TRACE_NOISE_GRID)


# ----------------------------------------------------------- (b) the rows
class _Result:
    """What ``_point`` reads off a result, drawn from ``seed``; with
    ``nan_seed`` its time per 1000 iterations is NaN, and its
    high-priority one always is where ``seed`` is a multiple of 40."""

    def __init__(self, seed: int, nan_seed: bool):
        rng = np.random.default_rng(seed)
        self.high_priority, self.low_priority = ["h"], ["l"]
        self._t = dict(all=math.nan if nan_seed else rng.uniform(90, 200),
                       h=math.nan if seed % 40 == 0 else rng.uniform(90, 200),
                       l=rng.uniform(90, 200))
        self.sim = SimpleNamespace(
            readjustments=int(rng.integers(0, 20)),
            reconfigurations=int(rng.integers(0, 10)),
            suppressed_reconfigurations=int(rng.integers(0, 4)),
            reconciliations=int(rng.integers(0, 15)))

    def mean_s_per_1000(self, jobs=None):
        return self._t["all" if jobs is None else jobs[0]]


def _same(a, b):
    return a == b or (isinstance(a, float) and isinstance(b, float)
                      and math.isnan(a) and math.isnan(b))


def test_rows_are_the_bench_s_field_for_field(monkeypatch):
    runs = _runs()
    # call 5 is the first D1 point's... its second x's third seed: a NaN
    stubs = [_Result(i + 1, nan_seed=i == 5) for i in range(len(runs))]
    _, want = _capture(monkeypatch, stubs)
    by_key = {key: r for (key, _, _), r in zip(runs, stubs)}
    got = cs.robustness_rows(lambda *key: by_key[key])
    assert len(got) == len(want) == 40
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert all(_same(g[k], w[k]) for k in g), (g, w)
    nan_point = got[1]  # (noise, D1, metronome, 0.05): one NaN seed
    assert not math.isnan(nan_point["t1000_mean_s"])
    assert nan_point["t1000_mean_s"] == pytest.approx(np.mean(
        [s.mean_s_per_1000() for s in stubs[3:6] if not
         math.isnan(s.mean_s_per_1000())]))
    assert not any(math.isnan(r["t1000_hi_s"]) for r in got)
    doc = results.to_robustness_dict(got)
    assert doc == rresults.to_robustness_dict(want)
    assert results.validate_robustness_dict(doc) == []
    assert rresults.validate_robustness_dict(doc) == []


def test_an_all_nan_column_stays_nan():
    """Every seed's high-priority time NaN: the point's is NaN (not a
    warning's mean of nothing), and the row still validates as null."""
    stubs = [_Result(40 * (i + 1), nan_seed=False) for i in range(3)]
    m = cs.robust_point(stubs)
    assert math.isnan(m["hi"]) and not math.isnan(m["t1000"])
    rows = cs.robustness_rows(lambda *key: stubs[key[-1] - 3])
    doc = results.to_robustness_dict(rows)
    assert all(r["t1000_hi_s"] is None for r in doc["rows"])
    assert results.validate_robustness_dict(doc) == []
    summary = cs.robustness_summary(doc["rows"])
    assert set(summary["failure_slope_per_cycle"]) == {
        "cycles", "metronome", "metronome-robust"}
    assert summary["robust_slope_shallower"] is False  # equal slopes


# ------------------------------------------ (c) both packages, live, small
@pytest.fixture()
def small(monkeypatch):
    for name, value in SMOKE.items():
        monkeypatch.setattr(cs, name, value)
    return cs.robust_trace()


def _ref_run(axis, sid, x, policy, backend="python"):
    """The bench's run at its smoke settings, built from the reference."""
    b = bench_robustness
    chan = {"noise": b._channel(noise=x), "trace": b._channel(noise=x),
            "staleness": b._channel(noise=b.AXIS_BASE_NOISE, staleness=x),
            "failure": b._channel(noise=b.AXIS_BASE_NOISE)}[axis]
    if axis == "trace":
        trace = rtrace.generate_trace(rtb.MODEL_FLEET,
                                      **SMOKE["ROBUST_TRACE_KW"])
        scn = rtb.trace_scenario(trace[:SMOKE["ROBUST_TRACE_JOBS"]],
                                 open_ended=True, name=sid)
        dur = SMOKE["ROBUST_TRACE_MS"]
    elif axis == "failure":
        scn = rtb.fault_scenario(sid, n_cycles=int(x),
                                 **SMOKE["ROBUST_FAULT_KW"])
        dur = SMOKE["ROBUST_SIM_MS"]
    else:
        scn = rtb.dynamic_scenario(sid, **SMOKE["ROBUST_DYNAMIC_KW"])
        dur = SMOKE["ROBUST_SIM_MS"]
    pol = next(p for p in b.POLICIES if p.name == policy)
    return rexp.run(scn, pol, rsim.SimConfig(
        duration_ms=dur, seed=3, jitter_std=0.01, telemetry=chan,
        fluid_backend=backend))


def _port_run(axis, sid, x, policy, trace, backend="python"):
    scn = cs.robust_scenario(axis, sid, x, 3, trace)
    scn = dataclasses.replace(scn, name=sid, sim_config=dataclasses.replace(
        scn.sim_config, fluid_backend=backend, device="cpu"))
    pol = next(p for p in cs.ROBUST_POLICIES if p.name == policy)
    return experiment.run(scn, pol)


LIVE_POINTS = [(axis, sid, x) for axis, sid, xs in cs.ROBUST_AXES[:4]
               for x in (xs[0], xs[-1])] + [
    ("trace", cs.ROBUST_TRACE_NAME, cs.TRACE_NOISE_GRID[-1])]
LIVE_CASES = [(*pt, p.name) for pt in LIVE_POINTS for p in cs.ROBUST_POLICIES]


@pytest.mark.parametrize("axis,sid,x,policy", LIVE_CASES,
                         ids=[f"{a}-{s}-x{x:g}-{p}"
                              for a, s, x, p in LIVE_CASES])
def test_results_json_equal(small, axis, sid, x, policy):
    want = _ref_run(axis, sid, x, policy)
    got = _port_run(axis, sid, x, policy, small)
    assert got.to_json_dict() == want.to_json_dict()
    if policy == "metronome":  # the ablation's controls stay off
        assert got.sim.suppressed_reconfigurations == 0
        assert got.sim.reconciliations == 0


def test_hysteresis_and_reconciliation_fire_in_both(small):
    """The robust policy sits R1's flaps, shorter than its 3 s debounce,
    out where the ablation replans on each, and adopts measured demand on
    D2 under noise 0.4: in both packages alike."""
    fired = {}
    for axis, sid, x in (("failure", "R1", cs.FLAP_GRID[-1]),
                         ("noise", "D2", cs.NOISE_GRID[-1])):
        for policy in ("metronome", "metronome-robust"):
            want = _ref_run(axis, sid, x, policy)
            got = _port_run(axis, sid, x, policy, small)
            assert got.to_json_dict() == want.to_json_dict()
            fired[sid, policy] = (got.sim.reconfigurations,
                                  got.sim.suppressed_reconfigurations,
                                  got.sim.reconciliations)
    assert fired["R1", "metronome-robust"][1] > 0
    assert fired["R1", "metronome"][0] > fired["R1", "metronome-robust"][0]
    assert fired["D2", "metronome-robust"][2] > 0
    assert all(fired[sid, "metronome"][1:] == (0, 0) for sid in ("R1", "D2"))


# --------------------------------- (d) the fill kernel's twin on the CPU
def _finished(res):
    return {j for j, t in res.sim.finish_times_ms.items()
            if not math.isnan(t)}


def test_kernel_on_cpu_tracks_the_reference_jnp(small):
    want = _ref_run("failure", "R1", cs.FLAP_GRID[-1], "metronome-robust",
                    backend="jnp")
    got = _port_run("failure", "R1", cs.FLAP_GRID[-1], "metronome-robust",
                    small, backend="kernel")
    assert got.accepted == want.accepted
    assert got.rejected == want.rejected
    assert got.placements == want.placements
    assert _finished(got) == _finished(want)
    assert got.sim.total_completion_ms == pytest.approx(
        want.sim.total_completion_ms, rel=1e-6)
    assert got.sim.suppressed_reconfigurations == \
        want.sim.suppressed_reconfigurations


# ------------------------------------------------------- (e) the twin pool
def _small_grid(live):
    """Two R1 cells at the smoke size, each with its own config."""
    cfg = simulator.SimConfig(
        duration_ms=SMOKE["ROBUST_SIM_MS"], seed=3, jitter_std=0.01,
        telemetry=telemetry.TelemetryChannel(noise_std=0.1), device="cpu")
    scns = tuple(dataclasses.replace(tb.fault_scenario(
        "R1", n_cycles=n, sim_config=cfg, **SMOKE["ROBUST_FAULT_KW"]),
        name=f"R1-{n}") for n in (0, 8))
    return live.Grid("r1", scns, (live.ROBUST_POLICIES[1],), None)


@pytest.fixture()
def live(monkeypatch):
    """chip_smoke under its own name, so the pool's spawned workers
    import it by name; launches counted as on the card."""
    mod = importlib.import_module("chip_smoke")
    inner = ops.metronome_fill

    def counting(*a, **kw):
        mod.metronome_fill.launches += 1
        return inner(*a, **kw)

    monkeypatch.setattr(ops, "metronome_fill", counting)
    monkeypatch.setattr(mod, "DEVICE", "cpu:0")
    monkeypatch.setattr(mod, "_sync", lambda: None)
    return mod


def test_twin_pool_equals_the_serial_twin(live, capsys):
    grid = _small_grid(live)
    serial = grid.run("cpu")
    with live.TwinPool([grid], 2) as pool:
        twin, seconds = pool.sweep(grid)
        stats = pool.stats()
    assert [c.to_json_dict() for c in twin.cells] == \
        [c.to_json_dict() for c in serial.cells]
    assert set(seconds) == {("R1-0", "metronome-robust"),
                            ("R1-8", "metronome-robust")}
    assert stats["workers"] == 2 and stats["cells"] == 2
    # the comparison path: the card side on "cpu:0", its twin from a pool
    launches = {}
    with live.TwinPool([grid], 2) as pool:
        got, totals = live.run_grids("t", [grid], launches,
                                     live.Recorder(), pool)
    assert totals["cells_json_equal_to_cpu_twin"] == 2
    assert totals["fill_launches"] > 0
    assert set(totals["grid_seconds"]["r1"]) == {"card", "cpu", "cpu_wait"}
    assert [c.to_json_dict()["result"]["sim"] for c in got["r1"].cells] == \
        [c.to_json_dict()["result"]["sim"] for c in serial.cells]


# ------------------------------- the corpus and experiment's own launches
@pytest.fixture()
def bookkeeping(monkeypatch):
    """The corpus and experiment phases on the CPU, the fill counted by a
    stub wrapper while ``counting[0]`` holds."""
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "_sync", lambda: None)
    monkeypatch.setattr(cs, "device_busy_share", lambda fn, note: {})
    monkeypatch.setattr(cs, "emit", lambda phase, **kw: None)
    inner, counting = ops.metronome_fill, [True]

    def stub(*a, **kw):
        if counting[0]:
            cs.metronome_fill.launches += 1
        return inner(*a, **kw)

    monkeypatch.setattr(ops, "metronome_fill", stub)
    return counting


def test_phases_report_their_own_fill_launches(bookkeeping):
    launches = {}
    corpus = cs.phase_trace_corpus(launches, cs.Recorder(keep=64),
                                   n_jobs=200, n_snap=8)
    assert corpus["fill_launches"] == launches["metronome_fill"] > 0
    exp = cs.phase_experiment(launches, cs.Recorder(), 12)
    assert 0 < exp["fill_launches"] == \
        launches["metronome_fill"] - corpus["fill_launches"]


def test_experiment_check_fails_when_its_run_launches_nothing(bookkeeping):
    launches = {}
    cs.phase_trace_corpus(launches, cs.Recorder(keep=64), n_jobs=200,
                          n_snap=8)
    assert launches["metronome_fill"] > 0  # the corpus's, a running total
    bookkeeping[0] = False
    with pytest.raises(AssertionError, match="experiment launched no fill"):
        cs.phase_experiment(launches, cs.Recorder(), 12)
