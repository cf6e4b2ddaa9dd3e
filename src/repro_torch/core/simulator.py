"""Event-driven fluid-flow cluster simulator.

Executes placed training jobs with periodic on-off traffic over the shared
fabric (the paper's contention model, generalized to multi-tier links):

  * each job iterates: compute phase -> synchronized communication phase;
  * during communication, each multi-node job places one flow per used host
    link with demand ``r^BW`` and volume ``r^BW * m_p``; when the job spans
    leaves, the flow also traverses its source leaf's spine uplink;
  * concurrent flows share bandwidth max-min fairly across their full link
    paths (progressive filling); on the default star topology every path is
    one host link and the allocation matches the seed's per-link
    water-filling bit-for-bit. Contention stretches the communication phase
    and stalls the next compute phase ("delayed flows stall the subsequent
    computations", section I);
  * compute-phase jitter models the paper's communication drift; the
    Metronome stop-and-wait controller pauses LOW priority jobs to realign.

Measured outputs per run: per-job iteration durations, average time per
1,000 iterations, per-link utilization (host links keyed by node name,
uplinks by ``uplink:<leaf>``), Gamma (Eq. 5), readjustment count, and total
completion time.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .. import _device
from . import events as events_mod
from . import topology
from .cluster import Cluster
from .contention import LinkView
from .controller import StopAndWaitController
from .fluid import FluidEngine
# rate-sharing primitives live in the backend-swappable fluid engine now;
# re-exported here because they are part of the simulator's historical API
from .fluid import _max_min_fair, _progressive_fill  # noqa: F401
from .telemetry import TelemetryChannel, TelemetryView
from .workload import HIGH, Job

EPS = 1e-9

COMPUTE, COMM, PAUSED, WAITING, DONE = "compute", "comm", "paused", "waiting", "done"
# a job with a task on a failed host: inert until every failed host returns
STALLED = "stalled"


@dataclasses.dataclass
class BackgroundFlow:
    """iPerf3-style unregulated traffic permanently occupying one link.

    ``node`` names a host link (the seed behavior); pass ``link`` to pin the
    traffic to any fabric link instead (e.g. ``uplink:leaf0`` for cross-rack
    background load)."""

    node: str
    rate_gbps: float
    link: Optional[str] = None

    @property
    def link_id(self) -> str:
        return self.link if self.link is not None else self.node


@dataclasses.dataclass
class SimConfig:
    duration_ms: float = 60_000.0
    jitter_std: float = 0.02  # compute-phase noise (fraction), causes drift
    startup_ms: float = 0.0
    latency_penalty_ms_per_tau: float = 1.0  # extra comm ms per unit tau above 1
    seed: int = 0
    sample_interval_ms: float = 1000.0
    monitor: bool = True  # enable the continuous monitoring mechanism
    # rate-sharing backend of the fluid engine (core/fluid.py):
    # 'python' (the bit-for-bit seed path), 'torch' (the plain PyTorch
    # fill), or 'kernel' (the CUDA fill kernel; the default)
    fluid_backend: str = "kernel"
    # where the vectorized fluid backends solve: 'cuda' (the default)
    # raises at construction on a machine without a card; 'cpu' runs the
    # plain PyTorch fill on the host
    device: str = "cuda"
    # None picks the backend default (off for python, on for vectorized);
    # True memoizes per affinity component so events re-fill only the
    # component they touch
    fluid_incremental: Optional[bool] = None
    # event-loop implementation (DESIGN.md section 17): 'array' keeps flow
    # state in contiguous arrays with dirty-link rate invalidation (the
    # production hot path, bit-for-bit equal to the seed on the python
    # backend); 'legacy' is the pre-array per-object loop, retained as the
    # parity oracle and the benchmark's pre-optimization reference
    event_loop: str = "array"
    # collect per-phase counters/timings into SimResult.profile
    profile: bool = False
    # observation channel for the control plane (DESIGN.md section 19):
    # None = oracle telemetry (the seed behavior, bit-for-bit); a
    # TelemetryChannel routes every scheduler/controller read of
    # allocatable bandwidth through sampled/noisy/stale observation
    telemetry: Optional[TelemetryChannel] = None
    # event-stream boundary validation: False (default) warn-onces and
    # drops malformed-value events, keeping the historical fire-time
    # UnknownEventTargetWarning for unknown targets; True raises a
    # structured events.EventValidationError on ANY problem before the
    # run starts
    strict_events: bool = False

    def __post_init__(self) -> None:
        if self.fluid_backend != "python":
            _device.resolve(self.device)


@dataclasses.dataclass
class SimProfile:
    """Per-phase counters/timings of one run (``SimConfig.profile``).

    Wall-clock seconds per event-loop phase plus work counters; attached to
    ``SimResult.profile`` and surfaced as rows of the dynamic-throughput
    bench artifact.  ``solves`` counts rate re-solves actually performed,
    ``skipped_assigns`` ticks where nothing was dirty — their ratio is the
    dirty-tracking win."""

    loop: str = ""
    ticks: int = 0
    assign_s: float = 0.0
    next_event_s: float = 0.0
    advance_s: float = 0.0
    events_s: float = 0.0
    step_s: float = 0.0
    events_applied: int = 0
    steps: int = 0
    solves: int = 0
    skipped_assigns: int = 0

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def phase_seconds(self) -> Dict[str, float]:
        return {"assign": self.assign_s, "next_event": self.next_event_s,
                "advance": self.advance_s, "events": self.events_s,
                "step": self.step_s}


@dataclasses.dataclass
class FlowState:
    job: str
    node: str  # source host link
    demand_gbps: float
    remaining_gb: float
    rate_gbps: float = 0.0
    # full link path (source host link first, then fabric links); defaults
    # to the host link only — the seed's star model
    links: Tuple[str, ...] = ()

    def __post_init__(self) -> None:
        if not self.links:
            self.links = (self.node,)


@dataclasses.dataclass
class JobState:
    job: Job
    phase: str = WAITING
    phase_end: float = math.inf
    flows: List[FlowState] = dataclasses.field(default_factory=list)
    iter_index: int = 0
    iter_start: float = 0.0
    durations_ms: List[float] = dataclasses.field(default_factory=list)
    pending_pause_ms: float = 0.0
    pause_in_iter_ms: float = 0.0  # controller-initiated pause this iteration
    realign_pending: bool = False
    start_time: float = 0.0
    finish_time: Optional[float] = None
    comm_extra_ms: float = 0.0  # latency penalty tail of the comm phase
    # array event loop: position in the simulator's job arrays (admission
    # order) and the flow-table slots of the current comm phase
    index: int = -1
    flow_slots: Optional[np.ndarray] = None
    # fault injection / drift (DESIGN.md section 19): failed hosts this
    # job has tasks on (non-empty <=> STALLED); silent multiplier on the
    # job's ACTUAL comm time vs its declared profile; wall-clock start of
    # the current comm phase (feeds measured-vs-declared reconciliation)
    stall_hosts: Set[str] = dataclasses.field(default_factory=set)
    drift_mult: float = 1.0
    comm_start: float = 0.0

    @property
    def name(self) -> str:
        return self.job.name


@dataclasses.dataclass
class SimResult:
    durations_ms: Dict[str, List[float]]
    time_per_1000_iters_s: Dict[str, float]
    link_utilization: Dict[str, float]
    avg_bw_utilization: float  # Gamma, Eq. 5
    readjustments: int
    finish_times_ms: Dict[str, float]
    total_completion_ms: float
    iterations_done: Dict[str, int]
    reconfigurations: int = 0  # controller reconfiguration ops (section III-C)
    # degradation control (DESIGN.md section 19): link changes the
    # hysteresis gate debounced, and measured-vs-declared profile
    # reconciliations adopted
    suppressed_reconfigurations: int = 0
    reconciliations: int = 0
    profile: Optional[SimProfile] = None  # set when SimConfig.profile

    def mean_iter_ms(self, job: str) -> float:
        d = self.durations_ms.get(job, [])
        return float(np.mean(d)) if d else math.nan

    @property
    def uplink_utilization(self) -> Dict[str, float]:
        """Utilization of spine uplinks only (empty on star topologies)."""
        return {k: v for k, v in self.link_utilization.items()
                if topology.is_uplink(k)}


_PHASE_CODE = {WAITING: 0, COMPUTE: 1, PAUSED: 2, COMM: 3, DONE: 4,
               STALLED: 5}
_COMM_CODE = _PHASE_CODE[COMM]


class _FlowTable:
    """Array-resident flow state (struct-of-arrays with a free list).

    The array event loop's single source of truth for per-flow state:
    ``demand``/``remaining``/``rate`` are float64 (the oracle's precision),
    ``job``/``pos`` key each slot to (job admission index, position inside
    the job's flow list) — the seed's iteration order, which every
    order-sensitive float reduction must replay — and the link incidence
    lives twice: as int rows of ``links`` (``-1``-padded, for vectorized
    delivered-GB scatters and component labeling) and as the original link
    id tuples in ``paths`` (for solver inputs and dirty marking).  Slots
    are recycled through a free list; capacity doubles on demand."""

    def __init__(self, link_index: Dict[str, int], cap: int = 64) -> None:
        self.link_index = link_index
        self.cap = cap
        self.maxp = 2
        self.demand = np.zeros(cap)
        self.remaining = np.zeros(cap)
        self.rate = np.zeros(cap)
        self.job = np.full(cap, -1, dtype=np.int64)
        self.pos = np.zeros(cap, dtype=np.int64)
        self.alive = np.zeros(cap, dtype=bool)
        self.links = np.full((cap, self.maxp), -1, dtype=np.int64)
        self.paths: List[Optional[Tuple[str, ...]]] = [None] * cap
        self._free = list(range(cap - 1, -1, -1))

    def _grow(self) -> None:
        old, new = self.cap, self.cap * 2
        for name in ("demand", "remaining", "rate"):
            arr = np.zeros(new)
            arr[:old] = getattr(self, name)
            setattr(self, name, arr)
        job = np.full(new, -1, dtype=np.int64)
        job[:old] = self.job
        self.job = job
        pos = np.zeros(new, dtype=np.int64)
        pos[:old] = self.pos
        self.pos = pos
        alive = np.zeros(new, dtype=bool)
        alive[:old] = self.alive
        self.alive = alive
        links = np.full((new, self.maxp), -1, dtype=np.int64)
        links[:old] = self.links
        self.links = links
        self.paths.extend([None] * old)
        self._free.extend(range(new - 1, old - 1, -1))
        self.cap = new

    def add(self, job_idx: int, pos: int, demand: float, remaining: float,
            path: Tuple[str, ...]) -> int:
        if not self._free:
            self._grow()
        if len(path) > self.maxp:
            wider = np.full((self.cap, len(path)), -1, dtype=np.int64)
            wider[:, : self.maxp] = self.links
            self.links = wider
            self.maxp = len(path)
        s = self._free.pop()
        self.demand[s] = demand
        self.remaining[s] = remaining
        self.rate[s] = 0.0
        self.job[s] = job_idx
        self.pos[s] = pos
        self.alive[s] = True
        self.links[s, :] = -1
        for k, l in enumerate(path):
            self.links[s, k] = self.link_index[l]
        self.paths[s] = path
        return s

    def free(self, s: int) -> None:
        self.alive[s] = False
        self.job[s] = -1
        self.paths[s] = None
        self._free.append(s)


class ClusterSimulator:
    def __init__(
        self,
        cluster: Cluster,
        jobs: Sequence[Job],
        config: SimConfig,
        controller: Optional[StopAndWaitController] = None,
        background: Sequence[BackgroundFlow] = (),
        traffic_changes: Sequence[Tuple[float, str, float]] = (),
        registry=None,
        framework=None,
        arrivals: Sequence = (),
        events: Sequence[events_mod.Event] = (),
        offline_recalc: bool = True,
        telemetry: Optional[TelemetryView] = None,
    ) -> None:
        """``events``: typed dynamic-environment events (see ``events.py``);
        ``traffic_changes`` — legacy (time_ms, job, duty_multiplier) tuples —
        are folded into the same timestamp-ordered stream.

        Online mode: pass ``framework`` + ``arrivals`` (workloads whose jobs
        carry submit_time_s). Workloads are scheduled when they arrive,
        queued when the cluster is full, and their pods are evicted on
        completion (the K8s behavior the paper's trace runs under).
        ``offline_recalc=False`` skips the controller's third-stage offline
        recalculation after each online admission (the trace-mode analogue
        of ``Policy.skip_third_stage``).

        ``telemetry``: a :class:`TelemetryView` proxy over ``cluster``.
        The fluid physics always runs on the true cluster; every
        controller interaction (reconfiguration, offline recalculation,
        re-baselining) goes through the proxy so the control plane sees
        only observed state.  ``None`` (with ``config.telemetry`` unset)
        is oracle mode — the seed behavior, bit-for-bit.
        """
        self.cluster = cluster
        self.config = config
        self.controller = controller
        if telemetry is None and config.telemetry is not None:
            telemetry = TelemetryView(cluster, config.telemetry,
                                      seed=config.seed)
        self.telemetry = telemetry
        # what the CONTROL PLANE reads: the observed proxy when a channel
        # is configured, the true cluster otherwise
        self._ctl_cluster = telemetry if telemetry is not None else cluster
        # fault-injection state: failed link -> its pre-failure
        # (capacity, allocatable) pair; currently-failed hosts
        self._failed_links: Dict[str, Tuple[float, Optional[float]]] = {}
        self._failed_hosts: Set[str] = set()
        self.offline_recalc = offline_recalc
        self.rng = np.random.default_rng(config.seed)
        self.jobs: Dict[str, JobState] = {}
        self.registry = registry
        self.framework = framework
        self.background = list(background)
        # unified demand/flow view (contention layer); flows_for reads the
        # live Job objects, so one instance serves the whole run
        self._link_view = LinkView(cluster)
        # backend-swappable rate-sharing core; the allocatable-capacity map
        # is cached per cluster epoch (every capacity/background mutation
        # bumps it), so steady-state iterations skip the rebuild
        self.fluid = FluidEngine(backend=config.fluid_backend,
                                 incremental=config.fluid_incremental,
                                 device=config.device)
        self._caps_fn: Optional[Callable[[str], float]] = None
        self._caps_epoch: int = -1
        self._events = collections.deque(
            events_mod.normalize_events(events, traffic_changes))
        self.delivered_gb: Dict[str, float] = {l: 0.0 for l in cluster.link_ids}
        self.now = 0.0
        self.rejected: List[str] = []
        if config.event_loop not in ("array", "legacy"):
            raise ValueError(
                f"unknown event_loop {config.event_loop!r}; "
                "expected 'array' or 'legacy'")
        self._array_mode = config.event_loop == "array"
        self.profile: Optional[SimProfile] = (
            SimProfile(loop=config.event_loop) if config.profile else None)
        # ---- array-resident state (DESIGN.md section 17) ----
        # link registry: contiguous delivered-GB vector aligned with the
        # cluster's link ids (the dict above stays the external view and is
        # synced at _result time in array mode)
        self._link_ids: List[str] = list(cluster.link_ids)
        self._link_index: Dict[str, int] = {
            l: i for i, l in enumerate(self._link_ids)}
        self._delivered_vec = np.zeros(len(self._link_ids))
        self._flows = _FlowTable(self._link_index)
        # job mirrors (index = admission order == jobs-dict order; entries
        # are never removed, matching the dict): phase code, next timed
        # event (inf when the phase has none), comm-flow bookkeeping
        self._jobs_list: List[JobState] = []
        self._jp = np.zeros(64, dtype=np.int8)
        self._jnext = np.full(64, math.inf)
        self._jhasflows = np.zeros(64, dtype=bool)
        self._junfin = np.zeros(64, dtype=np.int64)
        # dirty-link rate invalidation (component-granular refills)
        self._dirty_links: Set[str] = set()
        self._all_dirty = True
        self._last_fill_mode: Optional[str] = None
        # cached (job, pos)-ordered active slots + flattened path incidence
        self._order_stale = True
        self._act = np.empty(0, dtype=np.int64)
        self._flat_links = np.empty(0, dtype=np.int64)
        self._flat_rows = np.empty(0, dtype=np.int64)
        self._warned: Set[Tuple[str, str]] = set()
        # (arrival_ms, workload) queue for online scheduling
        self._arrivals = collections.deque(sorted(
            ((min(j.submit_time_s for j in wl.jobs) * 1e3, i, wl)
             for i, wl in enumerate(arrivals)),
            key=lambda t: (t[0], t[1])))
        self._pending = []  # workloads waiting for capacity
        for job in jobs:
            self._admit_job(job)

    @property
    def pending_jobs(self) -> List[str]:
        """Names of jobs whose workloads are queued waiting for capacity
        (online mode's rejected-so-far list)."""
        return [j.name for wl in self._pending for j in wl.jobs]

    def _admit_job(self, job: Job) -> None:
        config = self.config
        controller = self.controller
        st = JobState(job=job)
        base_start = max(self.now, job.submit_time_s * 1e3) + config.startup_ms
        if controller is not None:
            controller.set_baseline(job.name, job.traffic.period_ms,
                                    job.priority)
            align = controller.job_alignment(job.name)
            if align is not None:
                # delay the job start so its FIRST comm phase lands on
                # the assigned circle offset (absolute-time epoch)
                offset, period_eff = align
                inject = controller.injected_ms.get(job.name, 0.0)
                first_comm = base_start + job.traffic.compute_ms + inject
                base_start += (offset - first_comm) % period_eff
        st.start_time = base_start
        st.phase = WAITING
        st.phase_end = st.start_time
        self.jobs[job.name] = st
        self._register_job(st)

    # ------------------------------------------------------- online arrivals
    def _try_schedule(self, wl) -> bool:
        assert self.framework is not None
        if self.framework.schedule_workload(wl):
            if self.controller is not None and self.offline_recalc:
                self.controller.run_offline_recalculation(
                    self.framework.registry, self._ctl_cluster)
            for job in wl.jobs:
                self._admit_job(job)
            # a new scheme may shift existing low-priority jobs
            if self.controller is not None:
                for name, st in self.jobs.items():
                    job = st.job
                    if (st.phase not in (DONE,) and job.priority != HIGH
                            and name not in {j.name for j in wl.jobs}):
                        self._apply_realign(name)
            return True
        return False

    def _process_arrivals(self) -> None:
        while self._arrivals and self._arrivals[0][0] <= self.now + EPS:
            _, _, wl = self._arrivals.popleft()
            if not self._try_schedule(wl):
                self._pending.append(wl)

    def _on_job_done(self, st: JobState) -> None:
        if self.framework is not None:
            job_obj = self.framework.registry.jobs.get(st.job.name)
            if job_obj is not None:
                self.framework.evict_job(job_obj)
            # freed capacity: retry the pending queue in FIFO order
            still = []
            for wl in self._pending:
                if not self._try_schedule(wl):
                    still.append(wl)
            self._pending = still

    # --------------------------------------------------------------- traffic
    def _make_flows(self, job: Job, comm_ms: float) -> List[FlowState]:
        """One flow per used host link; the path extends over the source
        leaf's uplink when the job spans leaves.  The flow specification
        (which links, how much demand) comes from the unified contention
        layer — the simulator only adds volume (demand x ACTUAL comm
        time, which silent drift may have moved off the declared
        profile)."""
        return [
            FlowState(job.name, fs.node, fs.demand_gbps,
                      fs.demand_gbps * comm_ms / 1e3, links=fs.links)
            for fs in self._flow_specs(job)
        ]

    def _latency_penalty(self, job: Job) -> float:
        nodes = job.nodes_used()
        if len(nodes) <= 1:
            return 0.0
        worst = max(
            self.cluster.tau(a, b) for a in nodes for b in nodes if a != b
        )
        return self.config.latency_penalty_ms_per_tau * max(0.0, worst - 1.0)

    # ----------------------------------------------------------- rate sharing
    def _allocatable(self) -> Callable[[str], float]:
        """Per-link allocatable capacity (physical minus background),
        rebuilt only when the cluster epoch advances — every mutation path
        (capacity events, background ramps, allocations) bumps it."""
        epoch = self.cluster.epoch
        if self._caps_fn is None or self._caps_epoch != epoch:
            bg_by_link: Dict[str, float] = {}
            for bg in self.background:
                bg_by_link[bg.link_id] = (bg_by_link.get(bg.link_id, 0.0)
                                          + bg.rate_gbps)
            cache: Dict[str, float] = {}

            def cap_of(link_id: str) -> float:
                cap = cache.get(link_id)
                if cap is None:
                    cap = max(0.0, self.cluster.link_capacity(link_id)
                              - bg_by_link.get(link_id, 0.0))
                    cache[link_id] = cap
                return cap

            self._caps_fn = cap_of
            self._caps_epoch = epoch
        return self._caps_fn

    def _assign_rates(self) -> None:
        """Max-min fair share over each flow's link path, capped at r^BW.

        Delegates to the backend-swappable fluid engine (``core/fluid.py``).
        Star topology (every path a single host link): per-link water
        filling, numerically identical to the seed. Multi-link paths
        (fabric uplinks): progressive filling with per-link bottlenecks.
        """
        active = [f for st in self.jobs.values() for f in st.flows
                  if f.remaining_gb > EPS]
        if not active:
            return
        self.fluid.assign(active, self._allocatable())

    # ------------------------------------------------- array-resident state
    def _register_job(self, st: JobState) -> None:
        """Mirror a newly admitted job into the flat job arrays."""
        st.index = len(self._jobs_list)
        self._jobs_list.append(st)
        n = self._jp.shape[0]
        if st.index >= n:
            self._jp = np.concatenate([self._jp, np.zeros(n, dtype=np.int8)])
            self._jnext = np.concatenate([self._jnext, np.full(n, math.inf)])
            self._jhasflows = np.concatenate(
                [self._jhasflows, np.zeros(n, dtype=bool)])
            self._junfin = np.concatenate(
                [self._junfin, np.zeros(n, dtype=np.int64)])
        self._sync_job(st)

    def _sync_job(self, st: JobState) -> None:
        """Re-mirror one job's phase/phase_end after any transition.

        Invariant (DESIGN.md section 17): ``_jnext[i]`` is the job's next
        timed event — ``phase_end`` for WAITING/COMPUTE/PAUSED and for a
        flowless COMM phase (single-node sync or latency tail), ``inf``
        otherwise — so the array loop's next-event reduction is one min."""
        i = st.index
        code = _PHASE_CODE[st.phase]
        self._jp[i] = code
        if code <= 2 or (code == _COMM_CODE and not self._jhasflows[i]):
            self._jnext[i] = st.phase_end
        else:
            self._jnext[i] = math.inf

    def _flow_specs(self, job: Job):
        return self._link_view.flows_for(job, cache_epoch=self.cluster.epoch)

    def _start_comm_flows(self, st: JobState, comm_ms: float) -> bool:
        """Create the job's comm-phase flows; False for single-node jobs.

        Array mode registers table slots keyed (job index, spec position) —
        the seed's flow iteration order — and marks the touched links dirty;
        legacy mode builds the historical FlowState objects."""
        if not self._array_mode:
            st.flows = self._make_flows(st.job, comm_ms)
            return bool(st.flows)
        specs = self._flow_specs(st.job)
        if not specs:
            return False
        tbl = self._flows
        slots = np.empty(len(specs), dtype=np.int64)
        unfinished = 0
        for k, fs in enumerate(specs):
            remaining = fs.demand_gbps * comm_ms / 1e3
            slots[k] = tbl.add(st.index, k, fs.demand_gbps, remaining,
                               fs.links)
            if remaining > EPS:
                unfinished += 1
            self._dirty_links.update(fs.links)
        st.flow_slots = slots
        self._jhasflows[st.index] = True
        self._junfin[st.index] = unfinished
        self._order_stale = True
        return True

    def _clear_flows(self, st: JobState) -> None:
        """Release the job's flows (comm end / departure); still-active
        flows leave their links, so those links' rates are invalidated."""
        if not self._array_mode:
            st.flows = []
            return
        if st.flow_slots is not None:
            tbl = self._flows
            for s in st.flow_slots:
                if tbl.remaining[s] > EPS:
                    self._dirty_links.update(tbl.paths[s])
                tbl.free(s)
            self._order_stale = True
        st.flow_slots = None
        self._jhasflows[st.index] = False
        self._junfin[st.index] = 0

    def _job_has_flows(self, st: JobState) -> bool:
        if self._array_mode:
            return bool(self._jhasflows[st.index])
        return bool(st.flows)

    def _job_flows_done(self, st: JobState) -> bool:
        if self._array_mode:
            return self._junfin[st.index] == 0
        return all(f.remaining_gb <= EPS for f in st.flows)

    def _active_slots(self) -> np.ndarray:
        """Alive flows with volume left, in (job index, position) order —
        the seed's iteration order, which the order-sensitive float
        reductions (delivered-GB accumulation, per-link grouping) replay
        exactly.  Rebuilt only when flow membership changes; alongside it
        the flattened (slot row, path link) incidence used by the
        delivered-GB scatter-add."""
        if self._order_stale:
            tbl = self._flows
            alive = np.nonzero(tbl.alive)[0]
            act = alive[tbl.remaining[alive] > EPS]
            if act.size:
                act = act[np.lexsort((tbl.pos[act], tbl.job[act]))]
                sub = tbl.links[act]
                mask = sub >= 0
                rows, _ = np.nonzero(mask)
                self._flat_links = sub[mask]
                self._flat_rows = rows
            else:
                self._flat_links = np.empty(0, dtype=np.int64)
                self._flat_rows = np.empty(0, dtype=np.int64)
            self._act = act
            self._order_stale = False
        return self._act

    # ------------------------------------------------------------- main loop
    def run(self) -> SimResult:
        self._validate_events()
        if self._array_mode:
            return self._run_array()
        return self._run_legacy()

    def _validate_events(self) -> None:
        """Boundary validation of the event stream (DESIGN.md section 19).

        ``strict_events=True``: any problem — malformed values OR unknown
        targets — raises a structured ``EventValidationError`` before the
        clock starts.  Default mode: malformed-value events (NaN rates,
        negative capacities) are warn-onced and DROPPED (firing them
        would corrupt the fluid state); unknown-target events keep the
        historical fire-time ``UnknownEventTargetWarning`` path, so their
        reported ``time_ms`` stays the firing time."""
        if not self._events:
            return
        known_jobs = set(self.jobs)
        for _, _, wl in self._arrivals:
            known_jobs.update(j.name for j in wl.jobs)
        for wl in self._pending:
            known_jobs.update(j.name for j in wl.jobs)
        problems = events_mod.validate_stream(
            list(self._events),
            known_links=set(self.delivered_gb),
            known_hosts=set(self.cluster.nodes),
            known_jobs=known_jobs)
        if not problems:
            return
        if self.config.strict_events:
            raise events_mod.EventValidationError(problems)
        drop = set()
        for p in problems:
            if p.category != "bad-value":
                continue
            drop.add(p.index)
            key = ("value", f"{p.kind}:{p.name}")
            if key not in self._warned:
                self._warned.add(key)
                warnings.warn(f"{p.message} — event dropped", UserWarning,
                              stacklevel=3)
        if drop:
            self._events = collections.deque(
                ev for i, ev in enumerate(self._events) if i not in drop)

    def _run_legacy(self) -> SimResult:
        """The pre-array per-object event loop, preserved verbatim: the
        parity oracle of the array loop (pinned bit-for-bit by
        ``tests/test_event_loop.py``) and the ``bench_dynamic_throughput``
        pre-optimization reference."""
        cfg = self.config
        prof = self.profile
        perf = time.perf_counter
        while self.now < cfg.duration_ms:
            t0 = perf() if prof is not None else 0.0
            self._assign_rates()
            if prof is not None:
                t1 = perf()
                prof.assign_s += t1 - t0
                prof.solves += 1
            # next event time
            nxt = cfg.duration_ms
            for st in self.jobs.values():
                if st.phase in (COMPUTE, PAUSED, WAITING):
                    nxt = min(nxt, st.phase_end)
                elif st.phase == COMM:
                    if st.flows:
                        for f in st.flows:
                            if f.remaining_gb > EPS and f.rate_gbps > EPS:
                                nxt = min(nxt, self.now + f.remaining_gb / f.rate_gbps * 1e3)
                    else:
                        nxt = min(nxt, st.phase_end)
            if self._events:
                nxt = min(nxt, self._events[0].time_ms)
            if self._arrivals:
                nxt = min(nxt, self._arrivals[0][0])
            nxt = max(nxt, self.now)  # no time travel
            dt = nxt - self.now
            if prof is not None:
                t2 = perf()
                prof.next_event_s += t2 - t1

            # advance flows and accounting
            if dt > 0:
                for st in self.jobs.values():
                    for f in st.flows:
                        if f.remaining_gb > EPS:
                            moved = min(f.remaining_gb, f.rate_gbps * dt / 1e3)
                            f.remaining_gb -= moved
                            for l in f.links:
                                self.delivered_gb[l] += moved
                for bg in self.background:
                    self.delivered_gb[bg.link_id] += bg.rate_gbps * dt / 1e3
            self.now = nxt
            if self.telemetry is not None:
                self.telemetry.now_ms = self.now
            if prof is not None:
                t3 = perf()
                prof.advance_s += t3 - t2
                prof.ticks += 1
            if self.now >= cfg.duration_ms:
                break

            # dynamic-environment events (traffic / background / capacity /
            # departures), in timestamp order
            while self._events and self._events[0].time_ms <= self.now + EPS:
                self._apply_event(self._events.popleft())
                if prof is not None:
                    prof.events_applied += 1

            # online arrivals (may add jobs)
            self._process_arrivals()
            if prof is not None:
                t4 = perf()
                prof.events_s += t4 - t3

            # job phase transitions
            done_before = {n for n, s in self.jobs.items() if s.phase == DONE}
            for st in list(self.jobs.values()):
                self._step_job(st)
            for name, st in list(self.jobs.items()):
                if st.phase == DONE and name not in done_before:
                    self._on_job_done(st)
            if prof is not None:
                prof.step_s += perf() - t4
                prof.steps += len(self.jobs)
        return self._result()

    def _run_array(self) -> SimResult:
        """The array event loop: identical tick structure to the legacy
        loop, but every per-job/per-flow scan is a vectorized reduction
        over the flat mirrors and rates re-solve only when dirty.  With
        ``fluid_backend='python'`` the outputs are bit-for-bit equal to
        ``_run_legacy`` (the oracle-parity contract, DESIGN.md section
        17)."""
        cfg = self.config
        duration = cfg.duration_ms
        prof = self.profile
        perf = time.perf_counter
        tbl = self._flows
        dv = self._delivered_vec
        link_index = self._link_index
        while self.now < duration:
            t0 = perf() if prof is not None else 0.0
            self._assign_rates_array()
            if prof is not None:
                t1 = perf()
                prof.assign_s += t1 - t0

            # next event time: one min over job mirrors + one over flows
            nxt = duration
            n = len(self._jobs_list)
            if n:
                m = self._jnext[:n].min()
                if m < nxt:
                    nxt = float(m)
            act = self._active_slots()
            if act.size:
                r = tbl.rate[act]
                mask = r > EPS
                if mask.any():
                    m = (self.now + tbl.remaining[act[mask]] / r[mask] * 1e3).min()
                    if m < nxt:
                        nxt = float(m)
            if self._events:
                nxt = min(nxt, self._events[0].time_ms)
            if self._arrivals:
                nxt = min(nxt, self._arrivals[0][0])
            nxt = max(nxt, self.now)  # no time travel
            dt = nxt - self.now
            if prof is not None:
                t2 = perf()
                prof.next_event_s += t2 - t1

            # advance flows; delivered-GB scatter replays the seed's
            # (job, flow, path-link) accumulation order, then background
            if dt > 0:
                if act.size:
                    rem = tbl.remaining[act]
                    moved = np.minimum(rem, tbl.rate[act] * dt / 1e3)
                    new_rem = rem - moved
                    tbl.remaining[act] = new_rem
                    np.add.at(dv, self._flat_links, moved[self._flat_rows])
                    fin = new_rem <= EPS
                    if fin.any():
                        done_slots = act[fin]
                        for s in done_slots:
                            self._dirty_links.update(tbl.paths[s])
                        np.subtract.at(self._junfin, tbl.job[done_slots], 1)
                        self._order_stale = True
                for bg in self.background:
                    dv[link_index[bg.link_id]] += bg.rate_gbps * dt / 1e3
            self.now = nxt
            if self.telemetry is not None:
                self.telemetry.now_ms = self.now
            if prof is not None:
                t3 = perf()
                prof.advance_s += t3 - t2
                prof.ticks += 1
            if self.now >= duration:
                break

            # dynamic-environment events, in timestamp order
            while self._events and self._events[0].time_ms <= self.now + EPS:
                self._apply_event(self._events.popleft())
                if prof is not None:
                    prof.events_applied += 1

            # online arrivals (may add jobs)
            self._process_arrivals()
            if prof is not None:
                t4 = perf()
                prof.events_s += t4 - t3

            # job phase transitions: only DUE jobs step (the seed steps
            # every job every tick, but _step_job is a strict no-op unless
            # due — pinned by the oracle-parity tests), in admission order
            n = len(self._jobs_list)
            thresh = self.now + EPS
            due_mask = self._jnext[:n] <= thresh
            due_mask |= ((self._jp[:n] == _COMM_CODE)
                         & self._jhasflows[:n] & (self._junfin[:n] == 0))
            newly_done: List[JobState] = []
            due = np.nonzero(due_mask)[0]
            for i in due:
                st = self._jobs_list[i]
                self._step_job(st)
                if st.phase == DONE:
                    newly_done.append(st)
            for st in newly_done:
                self._on_job_done(st)
            if prof is not None:
                prof.step_s += perf() - t4
                prof.steps += int(due.size)
        return self._result()

    # ------------------------------------------- dirty-component rate solves
    def _assign_rates_array(self) -> None:
        """Re-solve rates only where invalidated (DESIGN.md section 17).

        Dirty marks come from flow creation/finish/removal (their links),
        capacity/background events (the event's link), and fill-mode
        transitions (everything).  Clean links keep their stored rates —
        bitwise-identical to the seed re-solving them, because the solve is
        deterministic in inputs that have not changed.

        python backend: all-single-link active sets refill per dirty link
        with the seed's ``_max_min_fair`` (groups in (job, pos) order);
        any multi-link path forces the seed's one global progressive fill.
        Vectorized backends: dirty affinity components are batched through
        one memo-aware ``fluid.solve_batch`` per tick."""
        act = self._active_slots()
        if act.size == 0:
            return
        if not self._dirty_links and not self._all_dirty:
            if self.profile is not None:
                self.profile.skipped_assigns += 1
            return
        tbl = self._flows
        link0 = tbl.links[act, 0]
        single = bool((tbl.links[act, 1:] < 0).all())
        mode = "single" if single else "multi"
        if mode != self._last_fill_mode:
            # per-link and global fills agree mathematically but not
            # bitwise; a mode flip invalidates every stored rate
            self._all_dirty = True
        self._last_fill_mode = mode
        cap_of = self._allocatable()
        if self.profile is not None:
            self.profile.solves += 1
        if self.fluid.backend == "python":
            if single:
                if self._all_dirty:
                    targets = np.unique(link0)
                else:
                    targets = sorted(self._link_index[l]
                                     for l in self._dirty_links)
                for li in targets:
                    grp = act[link0 == li]
                    if grp.size == 0:
                        continue
                    demands = tbl.demand[grp]
                    rates = _max_min_fair(demands, cap_of(self._link_ids[li]))
                    tbl.rate[grp] = rates
            else:
                demands = tbl.demand[act]
                paths = [tbl.paths[s] for s in act]
                caps = {l: cap_of(l) for p in paths for l in p}
                tbl.rate[act] = _progressive_fill(demands, paths, caps)
        else:
            self._assign_vectorized(act, cap_of)
        self._dirty_links.clear()
        self._all_dirty = False

    def _assign_vectorized(self, act: np.ndarray,
                           cap_of: Callable[[str], float]) -> None:
        """Batch every dirty affinity component through ONE memo-aware
        ``fluid.solve_batch`` call (= at most one shape-bucketed
        ``fill_corpus`` dispatch per tick)."""
        tbl = self._flows
        comps = self._components(act)
        dirty_vec = None
        if not self._all_dirty:
            dirty_vec = np.zeros(len(self._link_ids), dtype=bool)
            for l in self._dirty_links:
                dirty_vec[self._link_index[l]] = True
        problems = []
        targets = []
        for comp in comps:
            if dirty_vec is not None:
                sub = tbl.links[comp]
                if not dirty_vec[sub[sub >= 0]].any():
                    continue  # untouched component: stored rates stand
            paths = [tbl.paths[s] for s in comp]
            caps = {l: cap_of(l) for p in paths for l in p}
            problems.append((tbl.demand[comp], paths, caps))
            targets.append(comp)
        if problems:
            for comp, rates in zip(targets, self.fluid.solve_batch(problems)):
                tbl.rate[comp] = rates

    def _components(self, act: np.ndarray) -> List[np.ndarray]:
        """Affinity components of the active flows (flows connected when
        their paths share a link) by vectorized label propagation over the
        flow x link incidence — no per-flow Python union-find in the hot
        path.  Components keep (job, pos) flow order; ordered by first
        flow."""
        tbl = self._flows
        sub = tbl.links[act]
        mask = sub >= 0
        rows, _ = np.nonzero(mask)
        flat = sub[mask]
        lab = np.arange(len(self._link_ids), dtype=np.int64)
        n = act.size
        while True:
            flow_lab = np.full(n, np.iinfo(np.int64).max)
            np.minimum.at(flow_lab, rows, lab[flat])
            new_lab = lab.copy()
            np.minimum.at(new_lab, flat, flow_lab[rows])
            if (new_lab == lab).all():
                break
            lab = new_lab
        comps: Dict[int, List[int]] = {}
        for i in range(n):
            comps.setdefault(int(flow_lab[i]), []).append(int(act[i]))
        return [np.asarray(v, dtype=np.int64) for v in comps.values()]

    # -------------------------------------------------------- dynamic events
    def _apply_event(self, ev: events_mod.Event) -> None:
        if isinstance(ev, events_mod.TrafficChange):
            self._apply_traffic_change(ev.job, ev.duty_mult,
                                       declared=ev.declared)
        elif isinstance(ev, events_mod.BackgroundFlowChange):
            self._apply_bg_change(ev)
        elif isinstance(ev, events_mod.LinkCapacityChange):
            self._apply_capacity_change(ev)
        elif isinstance(ev, events_mod.JobDeparture):
            self._apply_departure(ev)
        elif isinstance(ev, events_mod.LinkFailure):
            self._apply_link_failure(ev)
        elif isinstance(ev, events_mod.LinkRecovery):
            self._apply_link_recovery(ev)
        elif isinstance(ev, events_mod.HostFailure):
            self._apply_host_failure(ev)
        elif isinstance(ev, events_mod.HostRecovery):
            self._apply_host_recovery(ev)
        else:  # pragma: no cover — defensive
            raise TypeError(f"unknown event {ev!r}")

    def _warn_unknown(self, kind: str, name: str) -> None:
        """Structured once-per-offender warning for events that name a
        link/job the simulator does not know (the event itself is still
        ignored, the seed behavior)."""
        key = (kind, name)
        if key in self._warned:
            return
        self._warned.add(key)
        warnings.warn(
            events_mod.UnknownEventTargetWarning(kind, name, self.now),
            stacklevel=2)

    def _apply_bg_change(self, ev: events_mod.BackgroundFlowChange) -> None:
        """Unregulated traffic on one link starts / ramps / stops."""
        if ev.link not in self.delivered_gb:
            self._warn_unknown("link", ev.link)
            return  # unknown link: ignore (mirrors unknown-job traffic change)
        self._dirty_links.add(ev.link)  # allocatable share changes
        kept = [bg for bg in self.background if bg.link_id != ev.link]
        if ev.rate_gbps > EPS:
            node = ev.link if ev.link in self.cluster.nodes else ""
            kept.append(BackgroundFlow(node=node, rate_gbps=ev.rate_gbps,
                                       link=ev.link))
        self.background = kept
        self.cluster.bump_epoch()  # background conditions changed
        if ev.adjust_allocatable:
            # NodeBandwidth-CR path (section III-A): the manager lowers the
            # allocatable share by the observed unregulated rate
            cap = self.cluster.link_capacity(ev.link)
            alloc = max(0.0, cap - max(0.0, ev.rate_gbps))
            self._set_allocatable(ev.link, alloc)
        self._reconfigure_links([ev.link])

    def _apply_capacity_change(self, ev: events_mod.LinkCapacityChange) -> None:
        """NodeBandwidth-CR update: allocatable and/or physical capacity.

        An explicit allocatable share from an earlier event never survives
        above the new physical capacity — the scheduler must not be told a
        link can allocate more than it can carry."""
        if ev.link in self.cluster.nodes:
            target = self.cluster.node(ev.link)
            cap_field = "bw_gbps"
        else:
            target = self.cluster.topology.link(ev.link)
            if target is None:
                self._warn_unknown("link", ev.link)
                return
            cap_field = "capacity_gbps"
        self._dirty_links.add(ev.link)
        if ev.capacity_gbps is not None:
            setattr(target, cap_field, float(ev.capacity_gbps))
        if ev.allocatable_gbps is not None:
            target.allocatable_gbps = float(ev.allocatable_gbps)
        if (target.allocatable_gbps is not None
                and target.allocatable_gbps > getattr(target, cap_field)):
            target.allocatable_gbps = float(getattr(target, cap_field))
        self.cluster.bump_epoch()  # invalidate epoch-scoped planner caches
        self._record_telemetry([ev.link])
        self._reconfigure_links([ev.link])

    # ---------------------------------------------------- fault injection
    def _link_target(self, link_id: str):
        """(object, capacity-field) pair for any known link id."""
        if link_id in self.cluster.nodes:
            return self.cluster.node(link_id), "bw_gbps"
        link = self.cluster.topology.link(link_id)
        if link is None:
            return None, ""
        return link, "capacity_gbps"

    def _fail_link(self, link_id: str) -> bool:
        """Drop a link's capacity and allocatable share to 0, remembering
        the pre-failure pair; False when already failed (flap overlap)."""
        if link_id in self._failed_links:
            return False
        target, cap_field = self._link_target(link_id)
        self._failed_links[link_id] = (getattr(target, cap_field),
                                       target.allocatable_gbps)
        setattr(target, cap_field, 0.0)
        target.allocatable_gbps = 0.0
        self._dirty_links.add(link_id)
        self.cluster.bump_epoch()
        self._record_telemetry([link_id])
        return True

    def _recover_link(self, link_id: str,
                      capacity_gbps: Optional[float] = None) -> bool:
        """Restore a failed link (optionally at a degraded physical
        capacity); False when the link is not failed."""
        saved = self._failed_links.pop(link_id, None)
        if saved is None:
            return False
        cap, alloc = saved
        if capacity_gbps is not None:
            cap = float(capacity_gbps)
            if alloc is not None:
                alloc = min(alloc, cap)
        target, cap_field = self._link_target(link_id)
        setattr(target, cap_field, cap)
        target.allocatable_gbps = alloc
        self._dirty_links.add(link_id)
        self.cluster.bump_epoch()
        self._record_telemetry([link_id])
        return True

    def _apply_link_failure(self, ev: events_mod.LinkFailure) -> None:
        if ev.link not in self.delivered_gb:
            self._warn_unknown("link", ev.link)
            return
        if self._fail_link(ev.link):
            self._reconfigure_links([ev.link])

    def _apply_link_recovery(self, ev: events_mod.LinkRecovery) -> None:
        if ev.link not in self.delivered_gb:
            self._warn_unknown("link", ev.link)
            return
        if self._recover_link(ev.link, ev.capacity_gbps):
            self._reconfigure_links([ev.link])

    def _apply_host_failure(self, ev: events_mod.HostFailure) -> None:
        """A worker dies: its host link fails and every job with a task
        on it stalls — flows drop (their links' rates re-solve), the
        interrupted iteration is abandoned, and the job stays inert (both
        loops: STALLED never appears in next-event reductions) until
        every failed host of the job recovers."""
        host = ev.host
        if host not in self.cluster.nodes:
            self._warn_unknown("host", host)
            return
        if host in self._failed_hosts:
            return
        self._failed_hosts.add(host)
        changed = self._fail_link(host)
        for st in self.jobs.values():
            if st.phase == DONE:
                continue
            if any(t.node == host for t in st.job.tasks):
                st.stall_hosts.add(host)
                if st.phase != STALLED:
                    self._clear_flows(st)
                    st.phase = STALLED
                    st.phase_end = math.inf
                    st.comm_extra_ms = 0.0
                    self._sync_job(st)
        if changed:
            self._reconfigure_links([host])

    def _apply_host_recovery(self, ev: events_mod.HostRecovery) -> None:
        """The worker returns: the host link recovers and jobs stalled
        only on it restart their interrupted iteration from its top
        (pending re-admission: the aborted partial iteration is not
        measured)."""
        host = ev.host
        if host not in self.cluster.nodes:
            self._warn_unknown("host", host)
            return
        if host not in self._failed_hosts:
            return
        self._failed_hosts.discard(host)
        changed = self._recover_link(host)
        for st in self.jobs.values():
            if host in st.stall_hosts:
                st.stall_hosts.discard(host)
                if not st.stall_hosts and st.phase == STALLED:
                    st.phase = WAITING
                    st.phase_end = max(self.now, st.start_time)
                    self._sync_job(st)
        if changed:
            self._reconfigure_links([host])

    def _record_telemetry(self, links: Sequence[str]) -> None:
        """Feed a capacity mutation into the telemetry truth history so
        samples taken later observe the value in force at sample time."""
        if self.telemetry is not None:
            self.telemetry.record_change(self.now, list(links))

    def _apply_departure(self, ev: events_mod.JobDeparture) -> None:
        st = self.jobs.get(ev.job)
        if st is None:
            # never admitted: the job departs from the arrival/pending
            # queues instead (trace truncation of a job that waited out its
            # whole window without getting capacity).  Strip just the
            # departed job — a multi-job workload (HPO sweep) keeps its
            # siblings queued; an emptied workload is dropped.
            def keep(wl) -> bool:
                wl.jobs = [j for j in wl.jobs if j.name != ev.job]
                return bool(wl.jobs)

            self._arrivals = collections.deque(
                t for t in self._arrivals if keep(t[2]))
            self._pending = [wl for wl in self._pending if keep(wl)]
            return
        if st.phase == DONE:
            return
        self._clear_flows(st)
        st.phase = DONE
        st.finish_time = self.now
        self._sync_job(st)
        if self.framework is not None:
            self._on_job_done(st)
            return
        # no framework: release placements and retire the job's schemes so
        # the live LinkView stops seeing the departed job (tasks keep their
        # node fields as a historical record for placement reporting)
        for t in st.job.tasks:
            if t.node is None:
                continue
            if t.node in self.cluster.nodes:
                self.cluster.node(t.node).release(t.uid, t.resources)
                self.cluster.bump_epoch()
            if self.controller is not None:
                self.controller.on_evict(t.node, t, registry=self.registry,
                                         cluster=self._ctl_cluster)
            if self.registry is not None:
                self.registry.tasks.pop(t.uid, None)
                self.registry.bump()
        if self.registry is not None:
            self.registry.jobs.pop(ev.job, None)
            self.registry.bump()

    def _set_allocatable(self, link_id: str, alloc: float) -> None:
        self._dirty_links.add(link_id)
        if link_id in self.cluster.nodes:
            self.cluster.node(link_id).allocatable_gbps = alloc
        else:
            link = self.cluster.topology.link(link_id)
            if link is not None:
                link.allocatable_gbps = alloc
        self.cluster.bump_epoch()  # invalidate epoch-scoped planner caches
        self._record_telemetry([link_id])

    def _reconfigure_links(self, link_ids: Sequence[str]) -> None:
        """The reconfiguration loop (paper section III-C): tell the
        controller which links changed; when it re-derives schemes, snap
        low-priority jobs to the new offsets (high priority never pays).
        The controller reads through ``_ctl_cluster`` — the telemetry
        proxy when one is configured — and gets the clock so its
        hysteresis gate can debounce."""
        if self.controller is None or self.registry is None:
            return
        n = 0
        for l in link_ids:
            n += self.controller.on_link_change(
                self.registry, self._ctl_cluster, l, now_ms=self.now)
        if n:
            for name, st in self.jobs.items():
                if st.phase != DONE and st.job.priority != HIGH:
                    self._apply_realign(name)

    def _apply_traffic_change(self, jname: str, duty_mult: float,
                              declared: bool = True) -> None:
        st = self.jobs.get(jname)
        if st is None:
            self._warn_unknown("job", jname)
            return
        if not declared:
            # silent drift: the job's ACTUAL comm volume/time changes but
            # its declared profile (and the controller's plans) do not —
            # only measured-vs-declared reconciliation can close the gap
            st.drift_mult *= duty_mult
            return
        spec = st.job.traffic
        new_comm = min(spec.period_ms, spec.comm_ms * duty_mult)
        new_spec = dataclasses.replace(
            spec, duty=new_comm / spec.period_ms
        )
        for t in st.job.tasks:
            t.traffic = dataclasses.replace(new_spec)
        if self.registry is not None:
            self.registry.bump()  # stored tasks' traffic changed in place
        if self.controller is not None and self.registry is not None:
            self.controller.report_traffic_change(
                self.registry, self._ctl_cluster, jname, new_spec
            )

    def _step_job(self, st: JobState) -> None:
        if st.phase == DONE:
            return
        job = st.job
        spec = job.traffic
        inject = 0.0
        if self.controller is not None:
            inject = self.controller.injected_ms.get(job.name, 0.0)

        if st.phase == WAITING and self.now + EPS >= st.phase_end:
            st.iter_start = self.now
            self._enter_compute(st, inject)
            return
        if st.phase in (COMPUTE, PAUSED) and self.now + EPS >= st.phase_end:
            # phase-aware drift detection (controller.report_phase_error)
            if self.controller is not None and self.config.monitor:
                align = self.controller.job_alignment(job.name)
                if align is not None:
                    offset, period_eff = align
                    err = (self.now - offset) % period_eff
                    for act in self.controller.report_phase_error(
                            job.name, err, period_eff):
                        self._apply_realign(act.job)
            # start synchronized communication; silent drift moves the
            # ACTUAL comm time off the declared profile (clipped at the
            # period, like a declared change would be)
            comm_ms = spec.comm_ms
            if st.drift_mult != 1.0:
                comm_ms = min(spec.period_ms, spec.comm_ms * st.drift_mult)
            has_flows = self._start_comm_flows(st, comm_ms)
            st.comm_extra_ms = self._latency_penalty(job)
            st.comm_start = self.now
            st.phase = COMM
            if not has_flows:
                # single-node job: loopback sync takes the ideal comm time
                st.phase_end = self.now + comm_ms + st.comm_extra_ms
            else:
                st.phase_end = math.inf
            self._sync_job(st)
            return
        if st.phase == COMM:
            if self._job_has_flows(st):
                if self._job_flows_done(st):
                    # flows done -> latency tail, then iteration completes
                    if st.comm_extra_ms > 0:
                        self._clear_flows(st)
                        st.phase_end = self.now + st.comm_extra_ms
                        st.comm_extra_ms = 0.0
                        self._sync_job(st)
                        return
                    self._clear_flows(st)
                    self._complete_iteration(st, inject)
            else:
                if self.now + EPS >= st.phase_end:
                    self._complete_iteration(st, inject)

    def _enter_compute(self, st: JobState, inject: float) -> None:
        spec = st.job.traffic
        jitter = 1.0 + self.rng.normal(0.0, self.config.jitter_std)
        dur = max(0.0, spec.compute_ms * max(0.1, jitter)) + inject
        dur += st.pending_pause_ms
        st.pause_in_iter_ms += st.pending_pause_ms
        st.pending_pause_ms = 0.0
        if st.realign_pending and self.controller is not None:
            align = self.controller.job_alignment(st.name)
            if align is not None:
                offset, period_eff = align
                pause = (offset - ((self.now + dur) % period_eff)) % period_eff
                dur += pause
                st.pause_in_iter_ms += pause
            st.realign_pending = False
        st.phase = COMPUTE
        st.phase_end = self.now + dur
        self._sync_job(st)

    def _complete_iteration(self, st: JobState, inject: float) -> None:
        dur = self.now - st.iter_start
        st.durations_ms.append(dur)
        st.iter_index += 1
        job = st.job
        ctl = self.controller
        if ctl is not None and self.config.monitor:
            # the controller knows which pauses IT injected — report the
            # organic iteration time so its own actions don't re-trigger
            # the drift rule (a realign storm otherwise)
            organic = max(0.0, dur - st.pause_in_iter_ms)
            actions = ctl.report_iteration(job.name, organic)
            for act in actions:
                self._apply_realign(act.job)
        if ctl is not None and getattr(ctl, "reconcile", False):
            # measured-vs-declared reconciliation: the controller sees
            # only the measured comm duration; when it decides the
            # declared profile has drifted, the simulator rewrites the
            # profile and rescales drift_mult so the job's ACTUAL
            # traffic is unchanged by the bookkeeping
            measured = max(0.0, self.now - st.comm_start)
            new_comm = ctl.reconcile_measurement(
                job.name, measured, job.traffic.comm_ms)
            if new_comm is not None:
                self._reconcile_traffic(st, new_comm)
        st.pause_in_iter_ms = 0.0
        if st.iter_index >= job.n_iterations:
            st.phase = DONE
            st.finish_time = self.now
            self._sync_job(st)
            return
        st.iter_start = self.now
        self._enter_compute(st, inject)

    def _reconcile_traffic(self, st: JobState, new_comm_ms: float) -> None:
        """Adopt a reconciled declared comm time for one job.

        The declared profile moves to ``new_comm_ms`` (the controller's
        measured estimate) and ``drift_mult`` is rescaled so the job's
        actual comm time is preserved — reconciliation is bookkeeping
        about *knowledge*, not a change of the underlying traffic."""
        spec = st.job.traffic
        new_comm_ms = min(spec.period_ms, new_comm_ms)
        if new_comm_ms <= EPS:
            return
        actual = min(spec.period_ms, spec.comm_ms * st.drift_mult)
        st.drift_mult = actual / new_comm_ms
        new_spec = dataclasses.replace(spec, duty=new_comm_ms / spec.period_ms)
        for t in st.job.tasks:
            t.traffic = dataclasses.replace(new_spec)
        if self.registry is not None:
            self.registry.bump()
        if self.controller is not None and self.registry is not None:
            self.controller.report_traffic_change(
                self.registry, self._ctl_cluster, st.name, new_spec)

    def _apply_realign(self, jname: str) -> None:
        """Stop-and-wait: pause a low-priority job so its next comm phase
        starts at its assigned offset on the circle (absolute-time epoch)."""
        st = self.jobs.get(jname)
        if st is None or st.phase == DONE or self.controller is None:
            return
        align = self.controller.job_alignment(jname)
        if align is None:
            return
        offset, period_eff = align
        if st.phase in (COMPUTE, PAUSED):
            projected = st.phase_end
            pause = (offset - (projected % period_eff)) % period_eff
            st.phase_end += pause
            st.pause_in_iter_ms += pause
            st.phase = PAUSED
            self._sync_job(st)
        else:
            # mid-comm: realign when the next compute phase begins
            st.realign_pending = True

    # ---------------------------------------------------------------- metrics
    def _result(self) -> SimResult:
        if self._array_mode:
            # delivered-GB lived in the float64 vector during the run (same
            # addition sequence as the legacy dict); publish it back
            for l, i in self._link_index.items():
                self.delivered_gb[l] = float(self._delivered_vec[i])
        elapsed = max(self.now, 1.0)
        link_ids = self.cluster.link_ids
        link_util = {}
        for l in link_ids:
            cap = self.cluster.link_capacity(l)
            if cap > 0:
                link_util[l] = min(1.0,
                                   self.delivered_gb[l] / (cap * elapsed / 1e3))
            else:  # link down at sim end (fault injection)
                link_util[l] = 0.0
        b_max = self.cluster.b_max
        caps = np.array([self.cluster.link_capacity(l) for l in link_ids])
        utils = np.array([link_util[l] for l in link_ids])
        # Eq. 5: capacity-weighted mean over links, normalized by B^max
        # (B^max stays the max HOST-link capacity; on the star topology this
        # is exactly the seed computation). Only links that carried (or
        # could carry) job traffic are counted.
        active = [i for i, l in enumerate(link_ids)
                  if self.delivered_gb[l] > 0]
        if active:
            gamma = float(np.mean(caps[active] * utils[active] / b_max))
        else:
            gamma = 0.0
        per_1000 = {}
        finish = {}
        iters = {}
        for name, st in self.jobs.items():
            if st.durations_ms:
                per_1000[name] = float(np.mean(st.durations_ms)) * 1000.0 / 1e3  # s
            else:
                per_1000[name] = math.nan
            finish[name] = st.finish_time if st.finish_time is not None else math.nan
            iters[name] = st.iter_index
        tct = max((f for f in finish.values() if not math.isnan(f)), default=self.now)
        return SimResult(
            durations_ms={n: st.durations_ms for n, st in self.jobs.items()},
            time_per_1000_iters_s=per_1000,
            link_utilization=link_util,
            avg_bw_utilization=gamma,
            readjustments=self.controller.readjust_count if self.controller else 0,
            finish_times_ms=finish,
            total_completion_ms=tct,
            iterations_done=iters,
            reconfigurations=(self.controller.reconf_count
                              if self.controller else 0),
            suppressed_reconfigurations=(
                self.controller.suppressed_reconf_count
                if self.controller else 0),
            reconciliations=(self.controller.reconcile_count
                             if self.controller else 0),
            profile=self.profile,
        )


