"""The Metronome stop-and-wait controller — paper section III-C.

Three duties:
  1. **Global offset**: per-link rotation schemes arrive from the scheduler;
     jobs spanning several links need consistent time-shifts. Offset
     resolution is delegated to the fabric-wide rotation planner
     (:func:`repro_torch.core.rotation.resolve`): consistent per-link solutions
     keep the Cassini-style affinity-graph BFS anchored at the *highest
     priority* job (the paper's difference vs Cassini's random reference);
     conflicting per-link solutions are re-solved jointly over every link
     the component touches.  ``joint=False`` restores the legacy
     "uplinks take precedence" tie-break as an ablation.
  2. **Offline recalculation**: when SkipPhaseThree == 0, re-run the
     exhaustive 3rd-stage search (maximize Psi among perfect-score interval
     midpoints) and update the scheme.
  3. **Continuous regulation**: monitor per-job iteration times; within a
     window of 10 iterations, if a job exceeds ``A_T`` x baseline more than
     ``O_T`` times, pause LOW priority jobs to realign their communication
     phases. High priority jobs are never touched.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import geometry, rotation
from .cluster import Cluster
from .contention import LinkView
from .framework import TaskRegistry
from .geometry import DI_PRE
from .rotation import LinkScheme
from .scheduler import ReserveMessage
from .topology import is_uplink
from .workload import HIGH, Task, TrafficSpec

MONITOR_WINDOW = 10  # fixed time window (iterations) — paper section III-C


@dataclasses.dataclass
class RealignAction:
    """Instruction to the node agent: pause a low-priority job."""

    job: str
    reason: str  # 'drift' | 'traffic_change'


@dataclasses.dataclass
class LinkState:
    """Current scheme on one fabric link.

    Keyed in :attr:`StopAndWaitController.links` by link id: host links use
    the node name (seed-compatible), spine uplinks ``uplink:<leaf>``."""

    scheme: LinkScheme
    optimal: bool  # False until offline recalculation has run


class StopAndWaitController:
    def __init__(
        self,
        *,
        a_t: float = 1.10,  # iteration-time factor threshold A_T
        o_t: int = 5,  # occurrence threshold O_T within the window
        di_pre: int = DI_PRE,
        recalc_hook: Optional[Callable[[str], None]] = None,
        phase_monitor: bool = False,
        reconfigure: bool = True,
        joint: bool = True,  # False = legacy uplink-wins reconciliation
        hysteresis_ms: float = 0.0,
        hysteresis_frac: float = 0.0,
        reconcile: bool = False,
        reconcile_frac: float = 0.25,
        reconcile_window: int = 8,
    ) -> None:
        self.a_t = a_t
        self.o_t = o_t
        self.di_pre = di_pre
        # dynamic reconfiguration (paper section III-C): react to capacity /
        # background changes by re-deriving schemes; False = ablation
        self.reconfigure = reconfigure
        self.reconf_count = 0
        # degradation control (DESIGN.md section 19): debounce the
        # reconfiguration loop so sampled/noisy telemetry cannot trigger
        # replan storms.  A link change is acted on only if at least
        # ``hysteresis_ms`` passed since its last acted-on change AND the
        # observed allocatable share moved by more than
        # ``hysteresis_frac`` x capacity since then.  Both 0 (default)
        # = the seed behavior: every reported change replans.
        self.hysteresis_ms = hysteresis_ms
        self.hysteresis_frac = hysteresis_frac
        self.suppressed_reconf_count = 0
        self._last_reconf_ms: Dict[str, float] = {}
        self._reconf_alloc: Dict[str, float] = {}
        # measured-vs-declared demand reconciliation: when a job's
        # measured comm time drifts off its declared profile by more than
        # ``reconcile_frac`` (median over ``reconcile_window``
        # iterations), adopt the measurement as the new declared profile
        self.reconcile = reconcile
        self.reconcile_frac = reconcile_frac
        self.reconcile_window = reconcile_window
        self.reconcile_count = 0
        self._measured_comm: Dict[str, collections.deque] = {}
        self.joint = joint
        self.joint_resolve_count = 0  # components re-solved jointly
        # epoch-scoped memo for the joint re-solves of offset resolution
        # (on_schedule replans after EVERY reserve; within one epoch the
        # conflicted components repeat — see DESIGN.md section 15)
        self.plan_cache = rotation.PlanCache()
        self.links: Dict[str, LinkState] = {}  # link id -> state (see LinkState)
        self.global_offsets_ms: Dict[str, float] = {}
        self.injected_ms: Dict[str, float] = {}  # per-job E_T idle injection
        self._history: Dict[str, collections.deque] = {}
        self._baseline_ms: Dict[str, float] = {}
        self._priorities: Dict[str, int] = {}
        self.readjust_count = 0
        self.recalc_count = 0
        self.pending_recalc: List[str] = []
        self.recalc_hook = recalc_hook
        self.phase_monitor = phase_monitor
        self._phase_strikes: Dict[str, int] = {}
        self._last_phase: Dict[str, float] = {}  # folded drift per job (ms)

    # ------------------------------------------------------------- scheduling
    def on_schedule(self, cluster: Cluster, registry: TaskRegistry,
                    msg: ReserveMessage) -> None:
        """Receive SEND(Shifts, SkipPhaseThree, P_l(n*)) from the scheduler."""
        for link_id, scheme in msg.schemes.items():
            skip = msg.skips.get(link_id, msg.skip_phase_three)
            self.links[link_id] = LinkState(scheme=scheme, optimal=skip)
            for j, inj in scheme.injected_ms.items():
                if inj > 0:
                    self.injected_ms[j] = inj
            if not skip:
                self.pending_recalc.append(link_id)
        for jname, job in registry.jobs.items():
            self._priorities[jname] = job.priority
        self._replan_offsets(registry, cluster)
        # offline recalculation is delegated (the paper decouples it from the
        # scheduling fast path); callers may run run_offline_recalculation()
        # asynchronously or via the hook.
        if self.recalc_hook is not None:
            while self.pending_recalc:
                self.recalc_hook(self.pending_recalc.pop())

    @staticmethod
    def _drop_job(state: LinkState, job: str) -> bool:
        """Remove ``job`` from a link scheme; True when the scheme empties."""
        sch = state.scheme
        if job in sch.jobs:
            idx = sch.jobs.index(job)
            sch.jobs.pop(idx)
            sch.shifts_slots = np.delete(sch.shifts_slots, idx)
            sch.muls = np.delete(sch.muls, idx)
        return not sch.jobs

    def on_evict(self, node: str, pod: Task,
                 registry: Optional[TaskRegistry] = None,
                 cluster: Optional[Cluster] = None) -> None:
        """Pod eviction: retire the job from the node's host-link scheme and
        from every uplink scheme it appears in (evictions are all-or-nothing
        at the job level, so the job's cross-leaf flows disappear too)."""
        dead: List[str] = []
        state = self.links.get(node)
        if state is not None and self._drop_job(state, pod.job):
            dead.append(node)
        for link_id, st in self.links.items():
            if is_uplink(link_id) and pod.job in st.scheme.jobs:
                if self._drop_job(st, pod.job):
                    dead.append(link_id)
        for link_id in dead:
            del self.links[link_id]
        self._replan_offsets(registry, cluster)

    # ---------------------------------------------------------- global offset
    def _replan_offsets(self, registry: Optional[TaskRegistry] = None,
                        cluster: Optional[Cluster] = None, *,
                        mode: str = "fast", demand: str = "planning") -> None:
        """Resolve the stored per-link schemes into global offsets via the
        rotation planner.  With a live (registry, cluster) the planner can
        re-solve conflicting components jointly; without one — or with
        ``joint=False`` — the legacy last-link-wins reconciliation applies
        (canonical order: host links sorted, uplinks LAST)."""
        schemes = {lid: st.scheme for lid, st in self.links.items()}
        view = None
        if registry is not None and cluster is not None:
            view = LinkView.from_registry(cluster, registry)
        res = rotation.resolve(
            schemes, self._priorities, view, registry, di_pre=self.di_pre,
            mode=mode, demand=demand, joint=self.joint,
            cache=self.plan_cache,
        )
        for lid, sch in res.schemes.items():
            if lid in self.links and sch is not schemes.get(lid):
                self.links[lid].scheme = sch
                # the joint re-solve owns its jobs' E_T injections: a new
                # commensurate unification may DROP an injection to zero,
                # and a stale positive entry would keep stretching the
                # job's period off the re-planned circle
                for j, inj in sch.injected_ms.items():
                    if inj > 0:
                        self.injected_ms[j] = inj
                    else:
                        self.injected_ms.pop(j, None)
        if res.joint_links:
            self.joint_resolve_count += 1
        self.global_offsets_ms = res.offsets_ms

    def job_offset_ms(self, job: str) -> float:
        base = 0.0
        for state in self.links.values():
            if job in state.scheme.jobs:
                base = state.scheme.base_ms
                break
        off = self.global_offsets_ms.get(job, 0.0)
        if base > 0:
            off = off % base
        return off

    def job_alignment(self, job: str) -> Optional[Tuple[float, float]]:
        """(offset_ms, effective_period_ms) for aligning the job's comm
        phases on the unified circle, or None if the job is unconstrained.

        The job's communication phases must start at absolute times
        ``t ≡ offset (mod period_eff)`` where period_eff = T_l / mul_p.
        """
        for state in self.links.values():
            sch = state.scheme
            if job in sch.jobs:
                mul = int(sch.muls[sch.jobs.index(job)])
                period_eff = sch.base_ms / max(mul, 1)
                off = self.global_offsets_ms.get(job, 0.0)
                # track the reference job's measured drift: alignment is
                # relative (common-mode fleet drift must not be fought).
                # Only under the experimental phase monitor — the paper's
                # iteration-time rule realigns to absolute offsets.
                if self.phase_monitor:
                    ref = sch.ref_job
                    if ref and ref != job:
                        off += self._last_phase.get(ref, 0.0)
                return off % period_eff, period_eff
        return None

    # ---------------------------------------------------- offline recalculation
    def run_offline_recalculation(
        self, registry: TaskRegistry, cluster: Cluster
    ) -> int:
        """Process pending SkipPhaseThree==0 links: exhaustive 3rd stage."""
        done = 0
        view = LinkView.from_registry(cluster, registry)
        while self.pending_recalc:
            link_id = self.pending_recalc.pop()
            state = self.links.get(link_id)
            if state is None:
                continue
            sch = state.scheme
            result = rotation.replan_link(view, link_id, sch,
                                          cluster.link_alloc(link_id),
                                          self.di_pre)
            sch.shifts_slots = result.shifts
            sch.score = result.score
            state.optimal = True
            self.recalc_count += 1
            done += 1
        self._replan_offsets(registry, cluster, mode="optimal",
                             demand="recalc")
        return done

    # -------------------------------------------------------- reconfiguration
    def on_link_change(self, registry: TaskRegistry, cluster: Cluster,
                       link_id: str, *,
                       now_ms: Optional[float] = None) -> int:
        """Dynamic reconfiguration (paper section III-C): the monitor reports
        that ``link_id``'s capacity/background conditions changed.

        Re-derives the link's rotation scheme from the live
        :class:`~repro_torch.core.contention.LinkView` (the new allocatable
        bandwidth feeds the 3rd-stage search) and re-baselines every job on
        the re-derived links to the *expected* iteration time under the new
        allocatable share — when a link can no longer carry a job's full
        demand, even a perfectly rotated comm phase stretches, and the
        A_T/O_T drift rule must not fight that unavoidable slowdown with
        realign pauses.  The planner's conflict resolution applies to the
        re-derived scheme too: when the new per-link solution disagrees
        with the schemes of other links the jobs traverse, the component is
        re-solved jointly.  Returns the number of schemes re-derived (0
        when reconfiguration is disabled, no scheme lives on the link,
        the link is observed dead, or the hysteresis gate suppressed the
        change).

        ``cluster`` may be a :class:`~repro_torch.core.telemetry.TelemetryView`
        proxy — the replan then works from the *observed* allocatable
        share; ``now_ms`` (the simulator clock) arms the hysteresis
        gate: changes within ``hysteresis_ms`` of the last acted-on
        change, or moving the observed share by no more than
        ``hysteresis_frac`` x capacity since then, are counted in
        ``suppressed_reconf_count`` and ignored."""
        state = self.links.get(link_id)
        if not self.reconfigure or state is None:
            return 0
        alloc = cluster.link_alloc(link_id)
        if alloc <= 1e-9:
            # link (observed) dead: there is no bandwidth to plan a
            # rotation against — flows are rate-0 regardless; the
            # recovery event replans and re-baselines
            return 0
        if now_ms is not None and (self.hysteresis_ms > 0.0
                                   or self.hysteresis_frac > 0.0):
            last_t = self._last_reconf_ms.get(link_id)
            if last_t is not None and now_ms - last_t < self.hysteresis_ms:
                self.suppressed_reconf_count += 1
                return 0
            ref = self._reconf_alloc.get(link_id)
            if ref is not None:
                cap = max(cluster.link_capacity(link_id), 1e-9)
                if abs(alloc - ref) <= self.hysteresis_frac * cap:
                    self.suppressed_reconf_count += 1
                    return 0
            self._last_reconf_ms[link_id] = now_ms
            self._reconf_alloc[link_id] = alloc
        if link_id not in self.pending_recalc:
            self.pending_recalc.append(link_id)
        affected = list(state.scheme.jobs)
        done = self.run_offline_recalculation(registry, cluster)
        view = LinkView.from_registry(cluster, registry)
        for j in affected:
            expected = view.expected_iteration_ms(j)
            if expected is not None and j in self._baseline_ms:
                self.set_baseline(j, expected, self._priorities.get(j, 0))
        self.reconf_count += 1
        return done

    # ------------------------------------------------------ continuous monitor
    def set_baseline(self, job: str, baseline_ms: float, priority: int) -> None:
        """Baseline = ideal contention-free iteration time (+ injected idle)."""
        self._baseline_ms[job] = baseline_ms + self.injected_ms.get(job, 0.0)
        self._priorities[job] = priority
        self._history[job] = collections.deque(maxlen=MONITOR_WINDOW)

    @staticmethod
    def _fold(err: float, pe: float) -> float:
        return ((err + pe / 2.0) % pe) - pe / 2.0

    def report_phase_error(self, job: str, error_ms: float,
                           period_eff_ms: float) -> List[RealignAction]:
        """BEYOND-PAPER (DESIGN.md section 11): agents also report the comm
        phase error vs the assigned offset. Sub-A_T partial overlaps drift
        forever under the paper's iteration-time rule; realigning when the
        RELATIVE error vs the link's reference job exceeds ~2 circle slots
        restores the cushion before it costs iteration time. The whole
        fleet drifts common-mode (iterations average above the ideal
        period), so only reference-relative error matters — absolute error
        would thrash.

        EXPERIMENTAL (default off): measured on S1-S5, chasing the
        reference's drift with one-report-old data lags the actual phase by
        ~one period of drift, so the realign pauses cost low-priority jobs
        more than the restored cushion saves (S2 lo +10% vs +2% under the
        paper's iteration-time rule). A drift-rate predictor would be
        needed to make this win; the paper-faithful monitor remains the
        default."""
        self._last_phase[job] = self._fold(error_ms, period_eff_ms)
        if not self.phase_monitor:
            return []
        ref = self._ref_of(job)
        if ref is None or ref == job:
            return []
        rel = self._fold(
            self._last_phase[job] - self._last_phase.get(ref, 0.0),
            period_eff_ms)
        tol = 2.0 * period_eff_ms * max(int(self._link_mul(job)), 1) / self.di_pre
        if abs(rel) <= tol:
            self._phase_strikes[job] = 0
            return []
        self._phase_strikes[job] = self._phase_strikes.get(job, 0) + 1
        if self._phase_strikes[job] < 3:  # debounce transient jitter
            return []
        self._phase_strikes[job] = 0
        actions = self._realign_actions(job)
        if actions:
            self.readjust_count += 1
            for a in actions:
                if a.job in self._history:
                    self._history[a.job].clear()
        return actions

    def _ref_of(self, job: str) -> Optional[str]:
        for state in self.links.values():
            sch = state.scheme
            if job in sch.jobs:
                return sch.ref_job or None
        return None

    def _link_mul(self, job: str) -> int:
        for state in self.links.values():
            sch = state.scheme
            if job in sch.jobs:
                return int(sch.muls[sch.jobs.index(job)])
        return 1

    def report_iteration(self, job: str, iter_ms: float) -> List[RealignAction]:
        """DDP/DeepSpeed-style iteration report. Returns realign actions when
        the A_T/O_T drift rule trips."""
        if job not in self._history:
            self.set_baseline(job, iter_ms, self._priorities.get(job, 0))
            return []
        hist = self._history[job]
        hist.append(iter_ms)
        base = self._baseline_ms.get(job, iter_ms)
        n_slow = sum(1 for x in hist if x > self.a_t * base)
        if n_slow > self.o_t:
            hist.clear()
            actions = self._realign_actions(job)
            if actions:
                self.readjust_count += 1
                # realignment perturbs every affected job's next iterations;
                # restart their windows so the pauses themselves don't trip
                # the rule again
                for a in actions:
                    if a.job in self._history:
                        self._history[a.job].clear()
            return actions
        return []

    def _realign_actions(self, job: str) -> List[RealignAction]:
        """Pause every LOW priority job sharing a link with ``job`` (including
        itself if low priority); high priority jobs are never paused.

        Realignment only makes sense where an interleave actually exists:
        links whose best scheme is imperfect (unavoidable contention, the
        SkipPhaseThree case 2 of the paper) are left alone — pausing cannot
        restore a separation that never existed."""
        affected: List[str] = []
        for state in self.links.values():
            sch = state.scheme
            if job in sch.jobs and sch.score >= 100.0 - 1e-6:
                affected.extend(sch.jobs)
        actions = []
        for j in sorted(set(affected)):
            if self._priorities.get(j, 0) != HIGH:
                actions.append(RealignAction(job=j, reason="drift"))
        return actions

    # ----------------------------------------------------- traffic-change path
    def reconcile_measurement(self, job: str, measured_ms: float,
                              declared_ms: float) -> Optional[float]:
        """Measured-vs-declared demand reconciliation (DESIGN.md sec. 19).

        The node agent reports each iteration's measured comm duration;
        when the median over ``reconcile_window`` reports deviates from
        the declared comm time by more than ``reconcile_frac``, return
        the median as the new declared comm time (the caller rewrites
        the profile and replans via ``report_traffic_change``).  Returns
        None while the evidence is insufficient.  The median over a full
        window is deliberately sluggish: transient contention stretches
        individual comm phases without representing a profile change."""
        if not self.reconcile or declared_ms <= 0.0:
            return None
        hist = self._measured_comm.get(job)
        if hist is None or hist.maxlen != self.reconcile_window:
            hist = collections.deque(maxlen=self.reconcile_window)
            self._measured_comm[job] = hist
        hist.append(measured_ms)
        if len(hist) < self.reconcile_window:
            return None
        med = float(np.median(list(hist)))
        if abs(med - declared_ms) <= self.reconcile_frac * declared_ms:
            return None
        hist.clear()
        self.reconcile_count += 1
        return med

    def report_traffic_change(self, registry: TaskRegistry, cluster: Cluster,
                              job: str, new_spec: TrafficSpec) -> None:
        """Duty-cycle / period change (batch-size change, congestion onset):
        update CRs and recalculate rotation angles (paper section III-C)."""
        view = LinkView.from_registry(cluster, registry)
        for t in view.job_tasks(job):
            t.traffic = dataclasses.replace(new_spec)
        registry.bump()  # stored tasks mutated in place -> new epoch
        for node, state in self.links.items():
            if job in state.scheme.jobs:
                # re-unify periods for this link and recalc
                jobs = state.scheme.jobs
                periods, prios = [], []
                for j in jobs:
                    tasks = view.job_tasks(j)
                    periods.append(tasks[0].traffic.period_ms if tasks else 100.0)
                    prios.append(self._priorities.get(j, 0))
                unified = geometry.unify_periods(periods, prios)
                state.scheme.base_ms = unified.base_ms
                state.scheme.muls = unified.muls
                state.scheme.injected_ms = {
                    j: float(unified.injected_ms[i]) for i, j in enumerate(jobs)
                }
                self.pending_recalc.append(node)
        self.run_offline_recalculation(registry, cluster)
        if job in self._history:
            self._history[job].clear()
        # measured-comm evidence referred to the OLD declared profile
        self._measured_comm.pop(job, None)
        # baseline must track the new traffic
        tasks = view.job_tasks(job)
        if tasks:
            self.set_baseline(job, tasks[0].traffic.period_ms,
                              self._priorities.get(job, 0))
    # NOTE: the legacy ``_recompute_global_offsets`` (BFS with add_edge
    # overwrite + uplink-LAST tie-break) is gone; offset resolution lives in
    # rotation.resolve() and the ablation flag ``joint=False`` preserves the
    # old tie-break semantics for comparison (bench_rotation.py).
