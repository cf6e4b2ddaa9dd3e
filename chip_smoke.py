#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the Metronome scheduling core on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It imports only ``repro_torch`` (from ``src/``), ``torch`` and ``numpy``,
builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` into
``build/kernels/``, and runs these phases on ``cuda:0``, each printing one
JSON line with its numbers and seconds:

  device        the card's name, count and ``nvidia-smi`` power limit
  build         one ``nvcc`` per kernel source, all started together
  trace_corpus  the 10,000-job production trace cut into 1024 active-set
                snapshots, filled by ``fluid.fill_corpus(backend='kernel')``
                and held against the float64 ``fill_python`` oracle
  experiment    ``experiment.run`` end to end on a production trace on the
                2-leaf x 2-host 2:1 leaf-spine fabric, fluid fill on the card,
                sampled in-loop solves held against ``fill_python``
  planner       J1 and F4 scheduled, then ``rotation.joint_solve`` and a
                candidate batch through ``joint_solve_batch`` with
                ``backend='kernel'`` held against ``backend='numpy'``
  kernels       each kernel wrapper against its plain PyTorch version on the
                very inputs the paths above gave it, plus a padding case and
                a wide candidate batch; CUDA-event times and bounds

Launch counts are zeroed just before each path and read just after it.
Every check that fails raises, so the script exits non-zero; it also exits
non-zero without a CUDA device.  The last lines are the kernel summary, the
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import _cuda_build  # noqa: E402
from repro_torch.configs.metronome_testbed import (MODEL_FLEET,  # noqa: E402
                                                   make_snapshot)
from repro_torch.core import events as events_mod  # noqa: E402
from repro_torch.core import fluid, rotation  # noqa: E402
from repro_torch.core.cluster import make_fabric_cluster  # noqa: E402
from repro_torch.core.contention import LinkView  # noqa: E402
from repro_torch.core.controller import StopAndWaitController  # noqa: E402
from repro_torch.core.experiment import Policy, Scenario, run  # noqa: E402
from repro_torch.core.framework import SchedulingFramework  # noqa: E402
from repro_torch.core.scheduler import MetronomePlugin  # noqa: E402
from repro_torch.core.simulator import SimConfig  # noqa: E402
from repro_torch.core.topology import is_uplink, uplink_id  # noqa: E402
from repro_torch.core.trace import (TraceJobSpec,  # noqa: E402
                                    active_jobs_at,
                                    generate_production_trace,
                                    trace_departure_events, trace_job_name,
                                    trace_to_jobs)
from repro_torch.core.workload import Workload  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.metronome_fill import metronome_fill  # noqa: E402
from repro_torch.kernels.metronome_score import (  # noqa: E402
    metronome_score_multilink, metronome_score_multilink_batch,
    metronome_score_pairwise)

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12

DEVICE = "cuda"

FILL_TOL = 1e-4     # kernel vs plain version (tests/test_kernels.py)
SCORE_TOL = 1e-4
ORACLE_TOL = 1e-6   # float32 fill vs the float64 fill_python oracle

SCORE_WRAPPERS = (metronome_score_multilink_batch, metronome_score_multilink,
                  metronome_score_pairwise)
ALL_WRAPPERS = (metronome_fill,) + SCORE_WRAPPERS


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# workloads (the port's copies of the reference benches' scenario builders)
# ---------------------------------------------------------------------------

# bench_trace_throughput: dumbbell fabric, 2 racks x 4 tiered-NIC hosts
NIC_TIERS = (1.0, 2.5, 10.0, 40.0)
PLACE_WEIGHTS = (0.08, 0.12, 0.30, 0.50)
TRUNK_GBPS = 10.0
CROSS_RACK_MOD = 10


def _pick_host(h: int) -> int:
    x = (h * 2654435761 % 2**32) / 2**32
    acc = 0.0
    for k, w in enumerate(PLACE_WEIGHTS):
        acc += w
        if x < acc:
            return k
    return len(PLACE_WEIGHTS) - 1


def snapshot_problem(trace: Sequence[TraceJobSpec], t_s: float):
    """The fill problem of the trace's active set at ``t_s``: each task on
    a weighted-hash host of its job's rack, cross-rack jobs over the trunk."""
    demands: List[float] = []
    paths: List[Tuple[str, ...]] = []
    for ji in active_jobs_at(trace, t_s):
        spec = trace[ji]
        bw = float(MODEL_FLEET[spec.model]["bw_gbps"])
        cross = (ji % CROSS_RACK_MOD == 0)
        for k in range(spec.n_tasks):
            rack = (ji + (k % 2 if cross else 0)) % 2
            host = f"h{rack}{_pick_host(ji * 31 + k)}"
            paths.append((host, "trunk") if cross else (host,))
            demands.append(bw)
    caps = {f"h{r}{k}": NIC_TIERS[k] for r in range(2)
            for k in range(len(NIC_TIERS))}
    caps["trunk"] = TRUNK_GBPS
    return demands, paths, caps


# bench_dynamic_throughput: 2 leaves x 2 hosts at 25 Gbps, 2:1 uplinks
N_LEAVES = 2
HOSTS_PER_LEAF = 2
OVERSUBSCRIPTION = 2.0
TRACE_KW = dict(median_duration_s=20.0, duration_sigma=1.0,
                duration_clip_s=(8.0, 80.0), task_multipliers=(1, 2),
                task_weights=(0.85, 0.15))
TIME_SCALE = 0.06
N_EVENT_BURSTS = 24


def synthetic_events(trace: Sequence[TraceJobSpec],
                     horizon_ms: float) -> List[events_mod.Event]:
    """Background ramps, uplink capacity dips and traffic changes across
    the run, plus unknown-target events that are warned about and dropped."""
    evs: List[events_mod.Event] = []
    hosts = [f"leaf{k}-host0" for k in range(min(4, N_LEAVES))]
    uplink = uplink_id("leaf0")
    for b in range(N_EVENT_BURSTS):
        t0 = horizon_ms * (b + 0.25) / N_EVENT_BURSTS
        t1 = horizon_ms * (b + 0.75) / N_EVENT_BURSTS
        host = hosts[b % len(hosts)]
        evs.append(events_mod.BackgroundFlowChange(t0, link=host,
                                                   rate_gbps=8.0))
        evs.append(events_mod.BackgroundFlowChange(t1, link=host,
                                                   rate_gbps=0.0))
        if b % 3 == 0:
            evs.append(events_mod.LinkCapacityChange(
                t0, link=uplink, allocatable_gbps=0.6 * HOSTS_PER_LEAF
                * 25.0 / OVERSUBSCRIPTION))
            evs.append(events_mod.LinkCapacityChange(
                t1, link=uplink, allocatable_gbps=None,
                capacity_gbps=HOSTS_PER_LEAF * 25.0 / OVERSUBSCRIPTION))
        if b % 4 == 0 and trace:
            ji = (b * 37) % len(trace)
            evs.append(events_mod.TrafficChange(
                t0, job=trace_job_name(trace[ji], ji),
                duty_mult=1.25 if b % 8 else 0.8))
    evs.append(events_mod.BackgroundFlowChange(horizon_ms * 0.1,
                                               link="ghost-host",
                                               rate_gbps=5.0))
    evs.append(events_mod.BackgroundFlowChange(horizon_ms * 0.2,
                                               link="ghost-host",
                                               rate_gbps=9.0))
    evs.append(events_mod.TrafficChange(horizon_ms * 0.15, job="ghost-job",
                                        duty_mult=2.0))
    return evs


def horizon_ms(trace: Sequence[TraceJobSpec],
               time_scale: float = TIME_SCALE) -> float:
    return max(s.submit_time_s + s.duration_s for s in trace) \
        * time_scale * 1e3


@dataclasses.dataclass(frozen=True)
class DynamicTraceBuild:
    """Production trace + departures + synthetic events on the
    oversubscribed 2x2 leaf-spine fabric, as a trace ``Scenario.build``."""

    trace: Tuple[TraceJobSpec, ...]
    time_scale: float = TIME_SCALE

    def __call__(self):
        cluster = make_fabric_cluster(
            n_leaves=N_LEAVES, hosts_per_leaf=HOSTS_PER_LEAF,
            bw_gbps=25.0, oversubscription=OVERSUBSCRIPTION)
        jobs = trace_to_jobs(list(self.trace), MODEL_FLEET,
                             time_scale=self.time_scale, open_ended=True)
        wls = []
        for j in jobs:
            wl = Workload(name=j.name, jobs=[j])
            j.workload = wl.name
            for t in j.tasks:
                t.workload = wl.name
            wls.append(wl)
        events = list(trace_departure_events(list(self.trace),
                                             time_scale=self.time_scale))
        events.extend(synthetic_events(self.trace,
                                       horizon_ms(self.trace,
                                                  self.time_scale)))
        return cluster, wls, (), events


def dynamic_trace_scenario(trace: Sequence[TraceJobSpec]) -> Scenario:
    return Scenario.trace(name="dynamic-trace",
                          build=DynamicTraceBuild(tuple(trace)))


DYNAMIC_POLICY = Policy("metronome", skip_third_stage=True,
                        rotation_joint=False)


def dynamic_sim_config(trace: Sequence[TraceJobSpec], **kw) -> SimConfig:
    return SimConfig(duration_ms=horizon_ms(trace) + 1_000.0, seed=3,
                     jitter_std=0.01, **kw)


@contextlib.contextmanager
def audited_engines(stride: int = 7):
    """Every ``FluidEngine`` built inside keeps each ``stride``-th in-loop
    solve (demands, paths, caps, rates) for an offline oracle audit."""
    engines: List[fluid.FluidEngine] = []
    init = fluid.FluidEngine.__init__

    def audited_init(self, *a, **kw):
        init(self, *a, **kw)
        self.sample_stride = stride
        engines.append(self)

    fluid.FluidEngine.__init__ = audited_init
    try:
        yield engines
    finally:
        fluid.FluidEngine.__init__ = init


def audit_error(engine: fluid.FluidEngine) -> float:
    """Max abs difference of the engine's sampled solves from the float64
    ``fill_python`` oracle."""
    err = 0.0
    for d, p, c, r in engine.samples:
        gold = fluid.fill_python(np.asarray(d, dtype=float), p, c)
        if len(gold):
            err = max(err, float(np.max(np.abs(r - gold))))
    return err


def schedule_snapshot(sid: str, n_iterations: int = 100):
    """``sid`` scheduled by the Metronome plugin with the joint planner."""
    cluster, wls, _ = make_snapshot(sid, n_iterations=n_iterations)
    ctrl = StopAndWaitController(joint=True)
    fw = SchedulingFramework(cluster, MetronomePlugin(controller=ctrl,
                                                      joint=True))
    for wl in wls:
        fw.schedule_workload(wl)
    return cluster, fw


def planner_links(sid: str, view: LinkView, registry) -> List[str]:
    """J1: every link with a per-link scheme (tests/test_rotation.py);
    F4: the contended uplinks (benchmarks/bench_rotation.py)."""
    if sid == "F4":
        return [l for l in view.planning_links() if is_uplink(l)]
    return [l for l in view.planning_links()
            if rotation.solve_link(view, registry, l)[1] is not None]


def candidate_specs(cluster, registry, links: Sequence[str], n: int):
    """``n`` candidate views of one component that differ only in their
    host links' allocatable bandwidth (the candidate delta of a Score
    phase), so ``joint_solve_batch`` scores them as one problem family."""
    specs = []
    for k in range(n):
        cl = cluster.copy()
        for lid in links:
            if lid in cl.nodes:
                node = cl.nodes[lid]
                node.allocatable_gbps = node.bw_gbps * (1.0 + 0.002 * k)
        specs.append((LinkView.from_registry(cl, registry), list(links)))
    return specs


# ---------------------------------------------------------------------------
# kernel inputs as the paths give them
# ---------------------------------------------------------------------------

class Recorder:
    """Keeps the host inputs the ops entry points received while active
    (at most ``keep`` calls per input shape) and the host time spent in
    them: the cast, the copy to the device, the launch and the copy back,
    which ends in a synchronisation."""

    NAMES = ("progressive_fill", "score_multilink", "score_multilink_batch")

    def __init__(self, keep: int = 1) -> None:
        self.keep = keep
        self.calls: Dict[str, Dict[tuple, list]] = {n: {} for n in self.NAMES}
        self.counts: Dict[str, Dict[tuple, int]] = {n: {} for n in self.NAMES}
        self.seconds: Dict[str, float] = {n: 0.0 for n in self.NAMES}

    @contextlib.contextmanager
    def active(self):
        saved = {n: getattr(ops, n) for n in self.NAMES}

        def wrap(name, fn):
            def recorded(*args, **kw):
                shape = tuple(np.shape(a) for a in args)
                self.counts[name][shape] = self.counts[name].get(shape, 0) + 1
                kept = self.calls[name].setdefault(shape, [])
                if len(kept) < self.keep:
                    kept.append([np.array(a, copy=True) for a in args])
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                self.seconds[name] += time.perf_counter() - t0
                return out
            return recorded

        for n in self.NAMES:
            setattr(ops, n, wrap(n, saved[n]))
        try:
            yield self
        finally:
            for n, fn in saved.items():
                setattr(ops, n, fn)

    def n_calls(self, name: str) -> int:
        return sum(self.counts[name].values())

    def inputs(self, name: str) -> List[list]:
        return [a for kept in self.calls[name].values() for a in kept]

    def most_common(self, name: str) -> Tuple[tuple, int, list]:
        shape, n = max(self.counts[name].items(), key=lambda kv: kv[1])
        return shape, n, self.calls[name][shape][0]


@contextlib.contextmanager
def counted(launches: Dict[str, int]):
    """Zero every wrapper's launch count, run the path, record the counts."""
    for w in ALL_WRAPPERS:
        w.launches = 0
    yield
    for w in ALL_WRAPPERS:
        launches[w.__name__] = launches.get(w.__name__, 0) + w.launches


def device_busy_share(fn) -> dict:
    """Run ``fn`` under ``torch.profiler`` and return the device's busy
    time (kernels and copies, one stream, so no overlap) over the wall
    time; "not measured" where the trace holds no device event."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = 0.0
    by_name: Dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += ev.self_device_time_total
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.self_device_time_total)
    if busy_us <= 0.0:
        return {"busy_share": "not measured", "wall_s": wall_us / 1e6}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"busy_share": busy_us / wall_us, "busy_s": busy_us / 1e6,
            "wall_s": wall_us / 1e6,
            "top_device_us": {k[:60]: v for k, v in top},
            "note": "profiled run of the trace's first fifth"}


def _sync() -> None:
    torch.cuda.synchronize()


def time_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after warm-up."""
    for _ in range(warmup):
        fn()
    _sync()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    info = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": line,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}
    emit("device", **info)
    return info


def phase_build() -> None:
    t0 = time.perf_counter()
    reports = _cuda_build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "bytes stack" in ln]
             for name, log in reports.items()}
    emit("build", seconds=seconds, sources=list(_cuda_build.SOURCES),
         built=sorted(reports), ptxas=ptxas)


def phase_trace_corpus(launches, rec: Recorder) -> dict:
    t0 = time.perf_counter()
    trace = generate_production_trace(MODEL_FLEET, n_jobs=10_000, seed=7)
    horizon = max(s.submit_time_s for s in trace)
    n_snap = 1024
    probs = [snapshot_problem(trace, horizon * (i + 0.5) / n_snap)
             for i in range(n_snap)]
    probs = [p for p in probs if p[0]]
    mats = [fluid.problem_matrix(d, p, c)[:3] for d, p, c in probs]
    n_flows = sum(len(p[0]) for p in probs)
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    golden = [fluid.fill_python(np.asarray(d, dtype=float), p, c)
              for d, p, c in probs]
    oracle_s = time.perf_counter() - t0

    fluid.fill_corpus(mats, backend="kernel", device=DEVICE)  # warm-up
    with counted(launches), rec.active():
        t0 = time.perf_counter()
        rates = fluid.fill_corpus(mats, backend="kernel", device=DEVICE)
        seconds = time.perf_counter() - t0
    err = max(float(np.max(np.abs(r - g))) if len(g) else 0.0
              for r, g in zip(rates, golden))
    check(launches["metronome_fill"] > 0, "trace corpus launched no fill")
    check(err <= ORACLE_TOL,
          f"trace corpus: kernel vs fill_python max abs err {err} > "
          f"{ORACLE_TOL}")
    out = dict(n_jobs=len(trace), n_problems=len(probs), n_flows=n_flows,
               max_flows=max(len(p[0]) for p in probs), n_links=9,
               seconds=seconds, problems_per_s=len(probs) / seconds,
               flows_per_s=n_flows / seconds, oracle_seconds=oracle_s,
               setup_seconds=setup_s,
               fill_launches=launches["metronome_fill"],
               max_abs_err_vs_fill_python=err)
    emit("trace_corpus", **out)
    return out


def phase_experiment(launches, rec: Recorder, n_jobs: int) -> dict:
    trace = generate_production_trace(MODEL_FLEET, n_jobs=n_jobs, seed=7,
                                      **TRACE_KW)
    scen = dynamic_trace_scenario(trace)
    cfg = dynamic_sim_config(trace, fluid_backend="kernel", device=DEVICE,
                             profile=True)
    with audited_engines() as engines, counted(launches), rec.active():
        t0 = time.perf_counter()
        res = run(scen, DYNAMIC_POLICY, cfg)
        _sync()
        seconds = time.perf_counter() - t0
    check(len(engines) == 1, f"expected one fluid engine, got {len(engines)}")
    eng = engines[0]
    err = audit_error(eng)
    sim = res.sim
    prof = sim.profile
    check(launches["metronome_fill"] > 0, "experiment launched no fill")
    check(len(eng.samples) > 0, "experiment sampled no in-loop solve")
    check(err <= ORACLE_TOL,
          f"experiment: in-loop fill vs fill_python max abs err {err}")
    check(math.isfinite(sim.total_completion_ms)
          and sim.total_completion_ms > 0, "total completion not finite")
    check(len(res.accepted) > 0, "no job was admitted")
    share = device_busy_share(
        lambda: run(dynamic_trace_scenario(trace[:n_jobs // 5]),
                    DYNAMIC_POLICY,
                    dynamic_sim_config(trace[:n_jobs // 5],
                                       fluid_backend="kernel",
                                       device=DEVICE)))
    out = dict(n_jobs=n_jobs,
               cut=f"{n_jobs} of the reference bench's 10,000 jobs, for "
                   "the run's time limit",
               ticks=prof.ticks, solves=prof.solves, seconds=seconds,
               us_per_tick=seconds * 1e6 / max(1, prof.ticks),
               phase_seconds=prof.phase_seconds(),
               total_completion_ms=sim.total_completion_ms,
               accepted=len(res.accepted), pending=len(res.rejected),
               fill_launches=launches["metronome_fill"],
               fill_op_calls=rec.n_calls("progressive_fill"),
               fill_op_seconds=rec.seconds["progressive_fill"],
               fill_op_us_per_call=rec.seconds["progressive_fill"] * 1e6
               / max(1, rec.n_calls("progressive_fill")),
               audited_solves=len(eng.samples),
               max_abs_err_vs_fill_python=err,
               device_busy=share,
               memo=dataclasses.asdict(eng.stats),
               corpus=eng.corpus_stats.as_dict())
    emit("experiment", **out)
    return out


def phase_planner(launches, rec: Recorder, n_candidates: int = 8) -> dict:
    out: Dict[str, dict] = {}
    t_all = time.perf_counter()
    for sid in ("J1", "F4"):
        cluster, fw = schedule_snapshot(sid)
        view = LinkView.from_registry(cluster, fw.registry)
        links = planner_links(sid, view, fw.registry)
        res_np = rotation.joint_solve(view, fw.registry, links,
                                      backend="numpy")
        with counted(launches), rec.active():
            t0 = time.perf_counter()
            res_k = rotation.joint_solve(view, fw.registry, links,
                                         backend="kernel", device=DEVICE)
            seconds = time.perf_counter() - t0
        check(res_np is not None and res_k is not None,
              f"{sid}: joint_solve returned None")
        check(np.array_equal(res_np.shifts, res_k.shifts),
              f"{sid}: kernel shifts {res_k.shifts} != numpy "
              f"{res_np.shifts}")
        check(abs(res_np.score - res_k.score) <= SCORE_TOL,
              f"{sid}: score {res_k.score} vs {res_np.score}")
        out[sid] = dict(links=links, jobs=res_k.jobs,
                        shifts=[int(s) for s in res_k.shifts],
                        score=res_k.score, feasible=bool(res_k.feasible),
                        seconds=seconds)
    # a Score phase's candidate batch: one family, one stacked launch
    cluster, fw = schedule_snapshot("J1")
    view = LinkView.from_registry(cluster, fw.registry)
    links = planner_links("J1", view, fw.registry)
    specs = candidate_specs(cluster, fw.registry, links, n_candidates)
    want = rotation.joint_solve_batch(specs, fw.registry, backend="numpy")
    with counted(launches), rec.active():
        t0 = time.perf_counter()
        got = rotation.joint_solve_batch(specs, fw.registry,
                                         backend="kernel", device=DEVICE)
        seconds = time.perf_counter() - t0
    for k, (a, b) in enumerate(zip(want, got)):
        check(np.array_equal(a.shifts, b.shifts),
              f"candidate {k}: kernel shifts {b.shifts} != {a.shifts}")
        check(abs(a.score - b.score) <= SCORE_TOL,
              f"candidate {k}: score {b.score} vs {a.score}")
    out["J1_batch"] = dict(candidates=n_candidates, seconds=seconds,
                           scores=[r.score for r in got])
    n_score = sum(launches.get(w.__name__, 0) for w in SCORE_WRAPPERS)
    check(n_score > 0, "planner launched no score kernel")
    check(launches.get("metronome_score_multilink_batch", 0) > 0,
          "the candidate batch did not reach the batched score launch")
    emit("planner", seconds=time.perf_counter() - t_all,
         score_launches={w.__name__: launches.get(w.__name__, 0)
                         for w in SCORE_WRAPPERS}, **out)
    return out


def _dev(arrays, dtypes) -> List[torch.Tensor]:
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=t)).to(DEVICE)
            for a, t in zip(arrays, dtypes)]


FILL_TYPES = (np.float32, np.uint8, np.float32)


def _fill_case(inputs: List[list]) -> dict:
    """Kernel vs plain fill on a list of (demands, routes, caps) launches:
    max error, CUDA-event times of the whole list, and its bound."""
    dev = [_dev(a, FILL_TYPES) for a in inputs]
    err = 0.0
    nbytes = 0
    n_ops = 0
    for d, r, c in dev:
        got = metronome_fill(d, r, c)
        want, rounds = ref._fill_rounds(d, r, c)
        _sync()
        check(bool(torch.isfinite(got).all()), "fill kernel: non-finite")
        err = max(err, float((got - want).abs().max()))
        bsz, f, l = r.shape
        nbytes += d.numel() * 4 + r.numel() + c.numel() * 4 + d.numel() * 4
        # per round: active counts (F*L), link shares (L), headroom (F),
        # updates (F + L), freeze test (F*L); rounds are this data's own
        n_ops += int(rounds.sum()) * (2 * f * l + 3 * f + 2 * l)
    ms = time_ms(lambda: [metronome_fill(*x) for x in dev])
    plain_ms = time_ms(lambda: [ref.progressive_fill_ref(*x) for x in dev],
                       reps=5, warmup=1)
    bound_ms, bound_by = _bound(nbytes, n_ops)
    return dict(launches_timed=len(dev),
                shapes=sorted({tuple(x[1].shape) for x in dev}),
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bytes=nbytes, operations=n_ops)


def _score_case(fn, plain, args: Sequence[np.ndarray], scalar=None) -> dict:
    """Kernel vs plain score on one launch's inputs."""
    dev = _dev(args, [np.float32] * len(args))
    extra = () if scalar is None else (scalar,)
    got = fn(*dev, *extra)
    want = plain(*dev, *extra)
    _sync()
    err = float((got - want).abs().max())
    check(bool(((got >= 0) & (got <= 100)).all()),
          f"{fn.__name__}: a score outside [0, 100]")
    ms = time_ms(lambda: fn(*dev, *extra))
    plain_ms = time_ms(lambda: plain(*dev, *extra))
    base, bank_a, bank_b = args[:3]
    s = base.shape[-1]
    ra, rb = bank_a.shape[-2], bank_b.shape[-2]
    links = int(np.prod(base.shape[:-1]))  # C * L
    # per (c, l, a, b, s): base+A+B-cap, max(., 0), +=; per (c, l, a, b):
    # divide, max over links
    n_ops = ra * rb * links * (4 * s + 2)
    nbytes = 4 * (base.size + bank_a.size + bank_b.size
                  + (1 if scalar is not None else args[3].size) + got.numel())
    bound_ms, bound_by = _bound(nbytes, n_ops)
    return dict(shape={"base": list(base.shape), "bank_a": list(bank_a.shape),
                       "bank_b": list(bank_b.shape)},
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bytes=nbytes, operations=n_ops)


def _bound(nbytes: int, n_ops: int) -> Tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _score_problem(seed: int, c: int, l: int, ra: int, rb: int, s: int):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.0, 8.0, (c, l, s))
    bank_a = rng.uniform(0.0, 12.0, (c, l, ra, s))
    bank_b = rng.uniform(0.0, 12.0, (c, l, rb, s))
    caps = rng.uniform(18.0, 30.0, (c, l))
    return base, bank_a, bank_b, caps


def phase_kernels(corpus: Recorder, loop: Recorder,
                  planner: Recorder) -> dict:
    cases: Dict[str, dict] = {}
    # fill: the trace corpus's buckets, the event loop's commonest launch
    cases["fill_trace_corpus"] = _fill_case(corpus.inputs("progressive_fill"))
    _, n, args = loop.most_common("progressive_fill")
    cases["fill_event_loop"] = dict(_fill_case([args]),
                                    calls_of_this_shape=n)
    # padded neutrality: zero-demand flows, zero-route unit-capacity links
    d = np.array([[0.0, 10.0, 0.0, 4.0] + [0.0] * 4])
    r = np.zeros((1, 8, 128))
    r[0, :4, 0] = 1.0
    c = np.ones((1, 128))
    c[0, 0] = 8.0
    got = metronome_fill(*_dev((d, r, c), FILL_TYPES)).cpu().numpy()
    check(got[0, 0] == 0.0 and got[0, 2] == 0.0 and np.all(got[0, 4:] == 0),
          "fill kernel: a padded flow got a rate")
    check(abs(got[0, 1] - 4.0) <= FILL_TOL and abs(got[0, 3] - 4.0)
          <= FILL_TOL, f"fill kernel: padded case rates {got[0, :4]}")
    cases["fill_padding"] = dict(rates=[float(x) for x in got[0, :4]])
    for name in ("fill_trace_corpus", "fill_event_loop"):
        check(cases[name]["max_abs_err"] <= FILL_TOL,
              f"{name}: kernel vs plain {cases[name]['max_abs_err']}")

    # score: the planner's own launches, then the wide candidate batch
    for name, fn, plain in (
            ("score_multilink", metronome_score_multilink,
             ref.metronome_score_multilink_ref),
            ("score_multilink_batch", metronome_score_multilink_batch,
             ref.metronome_score_multilink_batch_ref)):
        for i, args in enumerate(planner.inputs(name)):
            cases[f"{name}_planner{i}"] = _score_case(fn, plain, args)
    cases["score_multilink_batch_C64"] = _score_case(
        metronome_score_multilink_batch,
        ref.metronome_score_multilink_batch_ref,
        _score_problem(3, 64, 4, 72, 72, 72))
    base, bank_a, bank_b, caps = _score_problem(4, 1, 1, 36, 72, 72)
    cases["score_pairwise_36x72"] = _score_case(
        metronome_score_pairwise, ref.metronome_score_ref,
        (base[0, 0], bank_a[0, 0], bank_b[0, 0]), scalar=float(caps[0, 0]))
    # padding links (zero demand, unit capacity) score exactly 100
    base, bank_a, bank_b, caps = _score_problem(5, 2, 3, 24, 36, 72)
    zero = np.zeros_like
    pad = metronome_score_multilink_batch(*_dev(
        (zero(base), zero(bank_a), zero(bank_b), np.ones_like(caps)),
        [np.float32] * 4)).cpu()
    check(bool((pad == 100.0).all()), "padding links did not score 100")
    for name, case in cases.items():
        if name.startswith("score_"):
            check(case["max_abs_err"] <= SCORE_TOL,
                  f"{name}: kernel vs plain {case['max_abs_err']}")
    emit("kernels", tolerance={"fill": FILL_TOL, "score": SCORE_TOL},
         cases=cases)
    return cases


def kernel_summary(launches: Dict[str, int], cases: Dict[str, dict]) -> dict:
    fill = cases["fill_trace_corpus"]
    score = cases["score_multilink_batch_planner0"]
    score_err = max(v["max_abs_err"] for n, v in cases.items()
                    if n.startswith("score_") and "max_abs_err" in v)
    fill_err = max(v["max_abs_err"] for n, v in cases.items()
                   if n.startswith("fill_") and "max_abs_err" in v)
    kernels = [
        dict(name="metronome_fill", route="cuda",
             source="src/repro_torch/kernels/csrc/metronome_fill.cu",
             replaces="src/repro/kernels/metronome_fill.py:39",
             launches=launches.get("metronome_fill", 0),
             max_abs_err=fill_err, ms=fill["ms"], plain_ms=fill["plain_ms"],
             bound_ms=fill["bound_ms"], bound_by=fill["bound_by"],
             library_ms=None),
        dict(name="metronome_score", route="cuda",
             source="src/repro_torch/kernels/csrc/metronome_score.cu",
             replaces="src/repro/kernels/metronome_score.py:115",
             also_replaces=["src/repro/kernels/metronome_score.py:95",
                            "src/repro/kernels/metronome_score.py:39"],
             launches=sum(launches.get(w.__name__, 0)
                          for w in SCORE_WRAPPERS),
             wrapper_launches={w.__name__: launches.get(w.__name__, 0)
                               for w in SCORE_WRAPPERS},
             max_abs_err=score_err, ms=score["ms"],
             plain_ms=score["plain_ms"], bound_ms=score["bound_ms"],
             bound_by=score["bound_by"], library_ms=None),
    ]
    return {"kernels": kernels}


EXPERIMENT_JOBS = 1000


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    info = phase_device()
    phase_build()
    launches: Dict[str, int] = {}
    corpus, loop, planner = Recorder(keep=64), Recorder(), Recorder()
    phase_trace_corpus(launches, corpus)
    phase_experiment(launches, loop, EXPERIMENT_JOBS)
    phase_planner(launches, planner)
    cases = phase_kernels(corpus, loop, planner)
    print(json.dumps(kernel_summary(launches, cases)), flush=True)
    emit("total", seconds=time.perf_counter() - t_start, launches=launches)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
