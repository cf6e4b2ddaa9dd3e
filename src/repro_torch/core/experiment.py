"""Declarative Scenario/Policy experiment API (DESIGN.md section 14).

The paper evaluates a grid — 13 models x {static, fluctuating, trace}
scenarios x {Metronome, Default, Diktyo, Exclusive, Ideal} mechanisms — so
the entry point is grid-shaped instead of kwarg-shaped:

  * :class:`Scenario` — WHAT runs: a factory producing a fresh cluster,
    workloads, background flows and dynamic events per materialization.
    Offline-vs-trace is a scenario property (``mode``), not a separate
    function.
  * :class:`Policy` — HOW it is scheduled: the mechanism name (resolved
    through a pluggable registry, :func:`register_scheduler`) plus the
    Metronome ablation knobs (rotation mode, joint planner, reconfiguration
    loop, third stage) and scheduler-specific options (A_T/O_T, ...).
  * :func:`run` — one entry point subsuming the legacy ``run_experiment``
    AND ``run_trace_experiment`` (the reference's ``harness.py`` shims
    delegate there; the port does not carry them yet).  Trace
    runs accept every Policy knob — the legacy trace path hardcoded a
    default controller and could not ablate anything.
  * :func:`sweep` — the grid runner: every (scenario, policy) cell runs
    isolated (a raising cell records its traceback instead of aborting the
    grid) and the result serializes to schema-versioned JSON
    (``core/results.py``; benchmarks persist it as ``BENCH_sweep.json``).
"""
from __future__ import annotations

import copy
import dataclasses
import threading
import traceback
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple)

import numpy as np

from .baselines import DefaultPlugin, DiktyoPlugin, ExclusivePlugin
from .cluster import Cluster
from .controller import StopAndWaitController
from .events import Event
from .framework import SchedulerPlugin, SchedulingFramework
from .results import ExperimentResult, SweepCell, SweepResult
from .scheduler import MetronomePlugin
from .simulator import BackgroundFlow, ClusterSimulator, SimConfig, SimResult
from .telemetry import TelemetryView
from .workload import Job, Workload

OFFLINE, TRACE = "offline", "trace"

# (cluster, workloads[, background[, events]]) — what a Scenario's build
# callable returns; trailing elements optional
ScenarioData = Tuple[Cluster, List[Workload], List[BackgroundFlow],
                     List[Event]]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A declarative experiment input.

    ``build`` is called once per :func:`run` and must return a FRESH
    ``(cluster, workloads[, background[, events]])`` tuple — jobs are
    mutated by scheduling, so materializations must not share them (this is
    what the benchmarks' per-scheduler ``make_snapshot`` loop did by hand).

    ``mode='offline'`` schedules every workload up front (the paper's
    snapshot runs); ``mode='trace'`` feeds workloads to the simulator as
    online arrivals honoring ``submit_time_s`` (the paper's Fig. 10 K8s
    behavior) — jobs queue when the cluster is full and release capacity on
    completion.

    ``sim_config`` optionally pins the scenario's simulator configuration;
    an explicit ``sim_config=`` to :func:`run`/:func:`sweep` wins.
    """

    name: str
    build: Callable[[], Sequence]
    mode: str = OFFLINE
    sim_config: Optional[SimConfig] = None

    def __post_init__(self) -> None:
        if self.mode not in (OFFLINE, TRACE):
            raise ValueError(f"mode must be {OFFLINE!r} or {TRACE!r}, "
                             f"got {self.mode!r}")

    @classmethod
    def offline(cls, name: str, build: Callable[[], Sequence],
                **kw) -> "Scenario":
        return cls(name=name, build=build, mode=OFFLINE, **kw)

    @classmethod
    def trace(cls, name: str, build: Callable[[], Sequence],
              **kw) -> "Scenario":
        return cls(name=name, build=build, mode=TRACE, **kw)

    def materialize(self) -> ScenarioData:
        out = tuple(self.build())
        if not 2 <= len(out) <= 4:
            raise ValueError(
                f"scenario {self.name!r}: build() must return (cluster, "
                f"workloads[, background[, events]]), got {len(out)} items")
        cluster, workloads = out[0], list(out[1])
        background = list(out[2]) if len(out) > 2 else []
        events = list(out[3]) if len(out) > 3 else []
        return cluster, workloads, background, events


@dataclasses.dataclass(frozen=True)
class Policy:
    """A scheduling mechanism plus its ablation knobs.

    ``scheduler`` resolves through the registry (:func:`register_scheduler`);
    ``options`` carries scheduler-specific keyword options as a sorted
    tuple of pairs (hashable — use :meth:`with_options`), e.g. the
    controller thresholds ``a_t``/``o_t`` for Metronome.
    """

    scheduler: str
    rotation_mode: str = "intermediate"  # "compact" = no cushion slots
    rotation_joint: bool = True   # False = legacy uplink-wins tie-break
    reconfigure: bool = True      # False = no section III-C reconfiguration
    skip_third_stage: bool = False  # True = no offline recalculation
    options: Tuple[Tuple[str, Any], ...] = ()
    label: Optional[str] = None
    # fluid-engine rate-sharing backend for the simulation: None inherits
    # the SimConfig's ('kernel' by default); 'python' is the bit-for-bit
    # seed path, 'torch'/'kernel' the vectorized fill (core/fluid.py)
    sim_backend: Optional[str] = None

    @property
    def name(self) -> str:
        """Cell key in sweeps: the label, or an auto-name encoding every
        deviation from the defaults (so unlabeled ablations never collide)."""
        if self.label is not None:
            return self.label
        parts = [self.scheduler]
        if self.rotation_mode != "intermediate":
            parts.append(self.rotation_mode)
        if not self.rotation_joint:
            parts.append("legacyrot")
        if not self.reconfigure:
            parts.append("noreconf")
        if self.skip_third_stage:
            parts.append("wo3")
        if self.sim_backend is not None:
            parts.append(f"fluid={self.sim_backend}")
        parts.extend(f"{k}={v}" for k, v in self.options)
        return "-".join(parts)

    def scheduler_options(self) -> Dict[str, Any]:
        return dict(self.options)

    def with_options(self, **kw) -> "Policy":
        """A copy with ``kw`` merged into the scheduler-specific options."""
        merged = dict(self.options)
        merged.update(kw)
        return dataclasses.replace(
            self, options=tuple(sorted(merged.items())))


# ------------------------------------------------------------------ registry
# name -> factory(policy) -> (plugin, controller); the controller is None
# for mechanisms without a stop-and-wait stage.  "ideal" is the dedicated-
# cluster reference and is dispatched before the registry lookup.
SchedulerFactory = Callable[[Policy], Tuple[SchedulerPlugin,
                                            Optional[StopAndWaitController]]]
_SCHEDULERS: Dict[str, SchedulerFactory] = {}
_SCHEDULERS_LOCK = threading.Lock()
IDEAL = "ideal"


def register_scheduler(name: str, factory: SchedulerFactory,
                       *, overwrite: bool = False) -> None:
    """Plug a scheduling mechanism into :func:`run`/:func:`sweep`.

    ``factory(policy)`` returns ``(plugin, controller)``; the controller
    (may be ``None``) receives the offline recalculation and reconfiguration
    callbacks exactly like Metronome's."""
    if name == IDEAL:
        raise ValueError("'ideal' is the built-in dedicated-cluster "
                         "reference and cannot be re-registered")
    with _SCHEDULERS_LOCK:
        if name in _SCHEDULERS and not overwrite:
            raise ValueError(f"scheduler {name!r} already registered "
                             "(pass overwrite=True to replace)")
        _SCHEDULERS[name] = factory


def scheduler_names() -> Tuple[str, ...]:
    """Every runnable mechanism name (registry + the ideal reference)."""
    return tuple(_SCHEDULERS) + (IDEAL,)


def build_scheduler(policy: Policy) -> Tuple[SchedulerPlugin,
                                             Optional[StopAndWaitController]]:
    """Resolve ``policy.scheduler`` to a fresh (plugin, controller) pair."""
    try:
        factory = _SCHEDULERS[policy.scheduler]
    except KeyError:
        raise ValueError(f"unknown scheduler {policy.scheduler!r}; "
                         f"registered: {sorted(_SCHEDULERS)} + ['ideal']")
    return factory(policy)


def _metronome_factory(policy: Policy):
    controller = StopAndWaitController(reconfigure=policy.reconfigure,
                                       joint=policy.rotation_joint,
                                       **policy.scheduler_options())
    plugin = MetronomePlugin(controller=controller,
                             rotation_mode=policy.rotation_mode,
                             joint=policy.rotation_joint)
    return plugin, controller


register_scheduler("metronome", _metronome_factory)
register_scheduler("default", lambda policy: (DefaultPlugin(), None))
register_scheduler("diktyo", lambda policy: (DiktyoPlugin(), None))
register_scheduler("exclusive", lambda policy: (ExclusivePlugin(), None))


# ----------------------------------------------------------------------- run
def _priority_split(workloads: Sequence[Workload]
                    ) -> Tuple[List[str], List[str]]:
    hi, lo = [], []
    for wl in workloads:
        for j in wl.jobs:
            (hi if j.priority else lo).append(j.name)
    return hi, lo


def run(scenario: Scenario, policy: Policy,
        sim_config: Optional[SimConfig] = None) -> ExperimentResult:
    """Run one (scenario, policy) cell and return the typed result.

    Offline mode reproduces the legacy ``run_experiment`` bit-for-bit;
    trace mode reproduces ``run_trace_experiment`` bit-for-bit under the
    default :class:`Policy` and additionally honors every ablation knob the
    legacy trace path silently dropped (reconfigure / rotation_joint /
    rotation_mode / skip_third_stage / controller options).  Legacy
    ``traffic_changes`` tuples are normalized into the typed event stream
    before this boundary (the reference's ``harness.run_experiment``), so
    the simulator sees a single dynamic-input path.

    ``policy.scheduler == 'ideal'`` runs every job alone on a pristine copy
    of the cluster (the paper's dedicated-cluster reference).  It is the
    STATIC contention-free bound: background flows and events are
    deliberately ignored.
    """
    config = sim_config or scenario.sim_config or SimConfig()
    if (policy.sim_backend is not None
            and config.fluid_backend != policy.sim_backend):
        config = dataclasses.replace(config,
                                     fluid_backend=policy.sim_backend)
    cluster, workloads, background, events = scenario.materialize()
    hi, lo = _priority_split(workloads)

    if policy.scheduler == IDEAL:
        sim_res, accepted, placements = _run_ideal(cluster, workloads, config)
        return ExperimentResult(
            scenario=scenario.name, policy=policy.name, scheduler=IDEAL,
            accepted=accepted, rejected=[], placements=placements,
            high_priority=hi, low_priority=lo, sim=sim_res)

    cl = cluster.copy()
    plugin, controller = build_scheduler(policy)
    # Imperfect-information control plane (DESIGN.md section 19): when the
    # config carries a telemetry channel, EVERY control-plane read — Score/
    # Filter inside the framework, the controller's offline recalculation,
    # and the simulator's reconfiguration callbacks — observes link state
    # through one shared TelemetryView; the fluid physics keeps the truth.
    tel = (TelemetryView(cl, config.telemetry, seed=config.seed)
           if config.telemetry is not None else None)
    fw = SchedulingFramework(cl if tel is None else tel, plugin)

    if scenario.mode == OFFLINE:
        accepted, rejected = [], []
        jobs: List[Job] = []
        for wl in workloads:
            ok = fw.schedule_workload(wl)
            for j in wl.jobs:
                (accepted if ok else rejected).append(j.name)
                if ok:
                    jobs.append(j)
        if controller is not None and not policy.skip_third_stage:
            controller.run_offline_recalculation(
                fw.registry, cl if tel is None else tel)
        sim = ClusterSimulator(
            cl, jobs, config, controller=controller, background=background,
            registry=fw.registry, events=events, telemetry=tel,
        )
        res = sim.run()
        placements = {j.name: j.nodes_used() for j in jobs}
    else:  # TRACE: online arrivals at submit times, queueing, eviction
        sim = ClusterSimulator(
            cl, [], config, controller=controller, background=background,
            registry=fw.registry, framework=fw, arrivals=workloads,
            events=events, offline_recalc=not policy.skip_third_stage,
            telemetry=tel,
        )
        res = sim.run()
        accepted = list(sim.jobs)
        rejected = sim.pending_jobs
        placements = {n: st.job.nodes_used() for n, st in sim.jobs.items()}

    return ExperimentResult(
        scenario=scenario.name, policy=policy.name,
        scheduler=policy.scheduler, accepted=accepted, rejected=rejected,
        placements=placements, high_priority=hi, low_priority=lo, sim=res)


def _run_ideal(cluster: Cluster, workloads: Sequence[Workload],
               config: SimConfig):
    """Each job on a dedicated cluster: no contention, no shared links."""
    if config.telemetry is not None:
        # the dedicated-cluster reference is a STATIC contention-free bound;
        # observing it through a noisy channel would make it non-ideal
        config = dataclasses.replace(config, telemetry=None)
    merged_durations: Dict[str, List[float]] = {}
    per_1000: Dict[str, float] = {}
    finish: Dict[str, float] = {}
    iters: Dict[str, int] = {}
    gammas = []
    placements = {}
    for wl in workloads:
        for job in wl.jobs:
            cl = cluster.copy()
            job_copy = copy.deepcopy(job)
            job_copy.submit_time_s = 0.0
            fw = SchedulingFramework(cl, DefaultPlugin())
            if not fw.schedule_job(job_copy):
                continue
            sim = ClusterSimulator(cl, [job_copy], config)
            res = sim.run()
            merged_durations[job.name] = res.durations_ms[job_copy.name]
            per_1000[job.name] = res.time_per_1000_iters_s[job_copy.name]
            finish[job.name] = res.finish_times_ms[job_copy.name]
            iters[job.name] = res.iterations_done[job_copy.name]
            gammas.append(res.avg_bw_utilization)
            placements[job.name] = job_copy.nodes_used()
    sim_res = SimResult(
        durations_ms=merged_durations,
        time_per_1000_iters_s=per_1000,
        link_utilization={},
        avg_bw_utilization=float(np.mean(gammas)) if gammas else 0.0,
        readjustments=0,
        finish_times_ms=finish,
        total_completion_ms=max(
            (f for f in finish.values() if not np.isnan(f)), default=0.0
        ),
        iterations_done=iters,
    )
    return sim_res, list(merged_durations.keys()), placements


# --------------------------------------------------------------------- sweep
def _run_cell(scenario: Scenario, policy: Policy,
              sim_config: Optional[SimConfig]) -> SweepCell:
    """One isolated grid cell: a result, or the captured traceback."""
    try:
        res = run(scenario, policy, sim_config)
    except Exception:  # noqa: BLE001 — isolation is the contract
        return SweepCell(scenario=scenario.name, policy=policy.name,
                         status="error", error=traceback.format_exc())
    return SweepCell(scenario=scenario.name, policy=policy.name,
                     status="ok", result=res)


def sweep(scenarios: Sequence[Scenario], policies: Sequence[Policy],
          sim_config: Optional[SimConfig] = None,
          *, meta: Optional[Dict[str, Any]] = None,
          workers: int = 1, mode: str = "thread") -> SweepResult:
    """Run the full scenario x policy grid (row-major over scenarios).

    Per-cell error isolation: a cell that raises records its traceback in
    its :class:`~repro_torch.core.results.SweepCell` (``status="error"``) and the
    rest of the grid still runs.  Check ``result.errors`` (or use
    ``SweepResult.get``, which re-raises) when failures must surface.

    ``workers > 1`` fans the cells over a pool: every cell materializes its
    OWN scenario (fresh cluster/jobs — nothing shared) and runs a seeded,
    self-contained simulation, so cells are independent and the result —
    including the row-major cell order and per-cell error isolation — is
    identical to the serial run.  ``workers=1`` (the default) keeps the
    historical strictly-serial execution path.

    ``mode='thread'`` (default) uses a thread pool; ``mode='process'``
    fans cells over spawned worker processes — true parallelism for
    CPU-bound grids (10k-job production traces).  Process mode requires
    picklable scenarios/policies: use module-level build callables (the
    ``configs.metronome_testbed`` builders are dataclass instances for
    exactly this) and schedulers registered at import time of their
    defining module."""
    if mode not in ("thread", "process"):
        raise ValueError(f"mode must be 'thread' or 'process', got {mode!r}")
    grid = [(scenario, policy) for scenario in scenarios
            for policy in policies]
    if workers <= 1 or len(grid) <= 1:
        cells = [_run_cell(s, p, sim_config) for s, p in grid]
        return SweepResult(cells=cells, meta=dict(meta or {}))
    if mode == "process":
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        # spawn, not fork: workers re-import repro cleanly (no inherited
        # torch/BLAS state), matching how a fresh serial run would behave
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=min(workers, len(grid)),
                                 mp_context=ctx) as pool:
            futures = [pool.submit(_run_cell, s, p, sim_config)
                       for s, p in grid]
            cells = [f.result() for f in futures]  # row-major order
        return SweepResult(cells=cells, meta=dict(meta or {}))
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=min(workers, len(grid))) as pool:
        futures = [pool.submit(_run_cell, s, p, sim_config) for s, p in grid]
        cells = [f.result() for f in futures]  # preserves row-major order
    return SweepResult(cells=cells, meta=dict(meta or {}))
