"""The Metronome scheduler plugin — Algorithm 1 of the paper.

Implements the five extension points:

  PreFilter      : latency score Delta_n per node + resource caching
  Filter         : dependency-loop, CPU/MEM/GPU and bandwidth (Eq. 13-14)
  Score          : Eq. 18 via the fabric-wide rotation planner (1st opt.
                   stage + Eqs. 15-17, jointly over every traversed link)
  NormalizeScore : Eq. 19 latency tie-break (2nd opt. stage)
  Reserve        : state update + SEND(shifts, SkipPhaseThree) to controller
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import _graph, geometry, rotation
from .cluster import Cluster
from .contention import LinkView
from .framework import ScheduleContext, SchedulerPlugin, TaskRegistry
from .geometry import DI_PRE
from .rotation import LinkScheme
from .workload import Task

PERFECT = 100.0

# Beyond-paper rack-locality bonus: a candidate that makes the pod's job
# traverse a spine uplink scores this much below an intra-leaf candidate of
# equal rotation feasibility — prefer placements that need no uplink
# rotation at all.  Kept below 1.0 so rotation feasibility (and the
# dependency-loop cap at 99.0) always dominates the choice.
RACK_LOCALITY_PENALTY = 0.5

# Reconfiguration-aware Score penalty (DESIGN.md section 19): when the
# control plane observes through a telemetry channel, candidates whose
# traversed links show high observed fluctuation (EWMA coefficient of
# variation, ``TelemetryView.fluctuation``) are demoted — placing onto a
# flapping link invites reconfiguration churn.  The penalty is the worst
# traversed link's CV times this scale, so a 10%-CV link costs as much as
# the rack-locality preference; with an oracle cluster (no telemetry
# proxy) the penalty is identically 0.0 and scores are bit-for-bit the
# seed's.
FLUCTUATION_PENALTY_SCALE = 5.0


@dataclasses.dataclass
class ReserveMessage:
    """What Reserve SENDs to the stop-and-wait controller (Alg. 1 line 40).

    ``schemes`` maps every link the placement traverses and contends on
    (host link id == node name; uplinks ``uplink:<leaf>``) to its rotation
    scheme. ``skips`` carries the per-link SkipPhaseThree flag;
    ``skip_phase_three`` aggregates it (True when no link needs the offline
    3rd-stage recalculation)."""

    node: str
    schemes: Dict[str, LinkScheme]
    shifts_ms: Dict[str, float]
    skip_phase_three: bool
    skips: Dict[str, bool] = dataclasses.field(default_factory=dict)


class MetronomePlugin(SchedulerPlugin):
    name = "metronome"

    def __init__(
        self,
        controller=None,
        *,
        g_t_ms: float = 5.0,
        e_t_frac: float = 0.10,
        di_pre: int = DI_PRE,
        rotation_mode: str = "intermediate",  # 'compact' = stage-3 ablation
        joint: bool = True,  # False = legacy per-link solve (uplink-wins)
        memo: bool = True,  # False = ablation: re-solve per candidate
    ) -> None:
        self.controller = controller
        self.g_t_ms = g_t_ms
        self.e_t_frac = e_t_frac
        self.di_pre = di_pre
        self.rotation_mode = rotation_mode
        self.joint = joint
        # epoch-scoped content-keyed planner memo (DESIGN.md section 15):
        # the N candidate nodes of one Score phase share every per-link and
        # joint solve whose numeric problem coincides; ANY cluster/registry
        # mutation advances the epoch and drops the store
        self.plan_cache = rotation.PlanCache() if memo else None
        self.messages: List[ReserveMessage] = []

    # ------------------------------------------------------------------ utils
    def _candidate_view(self, cluster: Cluster, pod: Task, node_name: str,
                        registry: TaskRegistry) -> LinkView:
        """The unified demand view with ``pod`` provisionally on ``node_name``
        (the single source of truth for groupings/demand — contention.py)."""
        return LinkView.from_registry(cluster, registry, extra=pod,
                                      extra_node=node_name)

    # -------------------------------------------------------------- PreFilter
    def pre_filter(self, ctx: ScheduleContext, cluster: Cluster, pod: Task,
                   registry: TaskRegistry) -> None:
        """CALCULATELATENCYSCORE for every node + cache resources."""
        deps = registry.dependencies_of(pod)
        deployed_deps = [t for t in deps if t.node is not None]
        delta: Dict[str, float] = {}
        for n in cluster.node_names:
            total = sum(cluster.tau(n, t.node) for t in deployed_deps)
            if total == 0.0:
                # LowComm pod or no deployed dependency: use average latency
                # between the candidate node and all nodes in the cluster.
                total = float(np.mean([cluster.tau(n, m) for m in cluster.node_names]))
            delta[n] = total
        ctx.cache["delta"] = delta
        ctx.cache["deployed_deps"] = deployed_deps

    # ----------------------------------------------------------------- Filter
    def filter(self, ctx: ScheduleContext, cluster: Cluster, pod: Task,
               node_name: str, registry: TaskRegistry) -> bool:
        node = cluster.node(node_name)
        # resources (Eq. 13)
        if not pod.resources.fits_in(node.free):
            return False
        # bandwidth capacity (Eq. 14), on EVERY link the pod's flows would
        # traverse: the host link, plus the candidate leaf's uplink when the
        # placement makes the pod's job span leaves
        if pod.traffic.bw_gbps > node.alloc_bw:
            return False
        topo = cluster.topology
        if not topo.is_star and not pod.low_comm:
            view = self._candidate_view(cluster, pod, node_name, registry)
            if topo.leaf_of[node_name] in view.traversed_uplinks(pod.job):
                up = topo.uplink_of(node_name)
                if up is not None and pod.traffic.bw_gbps > up.alloc_bw:
                    return False
        # Dependency loops (Cassini) are handled at the Score phase: on a
        # loaded cluster a hard filter would leave pods unschedulable, and
        # the paper's own section V prescribes scoring toward less-contended
        # nodes instead. The loop check caps the node's score below perfect
        # so loop-free placements always win ties (see score()).
        return True

    def _dependency_loop_closure(self, view: LinkView, pod: Task,
                                 base_pairs: Optional[Dict[str, List[Tuple[
                                     str, str]]]] = None
                                 ) -> Tuple[bool, List[str]]:
        """Cassini's affinity-loop filter, restricted to edges that matter.

        Only *contending* pairs (the LinkView's Eq. 9 predicate: combined
        demand exceeding the link's allocatable capacity) constrain
        relative rotations; sub-capacity co-location imposes nothing. And a
        pre-existing loop between other jobs is not this pod's problem: we
        flag the node only when the NEW placement closes a cross-link
        cycle through the pod's own job.

        Returns ``(loop, closure_links)``: whether such a cycle exists, and
        every link of the pod's affinity component (the links a joint solve
        must cover to give the cycle one consistent set of offsets).

        ``base_pairs`` optionally carries the candidate-independent
        contending pairs (computed WITHOUT the extra pod): the candidate
        delta can only change the extra node's host link — and, off star
        topologies, uplink groupings — so every other link's pairs are
        shared across the N candidates of one Score phase.
        """
        topo = view.cluster.topology
        affected = {view.extra_node} if view.extra is not None else set()
        if not topo.is_star:
            affected.update(topo.uplink_ids)
        g = _graph.Graph()
        for link_id in view.planning_links():
            if base_pairs is not None and link_id not in affected:
                pairs = base_pairs[link_id]
            else:
                pairs = view.contending_pairs(link_id)
            for a, b in pairs:
                if g.has_edge(a, b):
                    g[a][b]["links"].add(link_id)
                else:
                    g.add_edge(a, b, links={link_id})
        # a 2-job multi-link relation needs only one relative shift, which
        # the rotation planner resolves (consistent per-link solutions are
        # kept; conflicts trigger the joint multi-link solve); cross-link
        # cycles of length >= 3 THROUGH THIS JOB couple links beyond the
        # pod's own traversal — only a joint solve over the whole closure
        # can give them consistent offsets.
        if pod.job not in g:
            return False, []
        comp = _graph.node_connected_component(g, pod.job)
        closure = {l for u, v, d in g.subgraph(comp).edges(data=True)
                   for l in d["links"]}
        closure_links = [l for l in view.planning_links() if l in closure]
        loop = False
        try:
            for cyc in _graph.cycle_basis(g, pod.job):
                if len(cyc) < 3 or pod.job not in cyc:
                    continue
                common = None
                for a, b in zip(cyc, cyc[1:] + cyc[:1]):
                    links = g[a][b]["links"]
                    common = set(links) if common is None else common & links
                if not common:
                    loop = True
                    break
        except _graph.NetworkXError:
            pass
        return loop, closure_links

    # ------------------------------------------------------------------ Score
    def _candidate_links(self, cluster: Cluster, view: LinkView, pod: Task,
                         node_name: str) -> List[str]:
        """Every link the candidate placement's flows would traverse."""
        return [node_name] + [
            cluster.topology.uplinks[leaf].id
            for leaf in view.traversed_uplinks(pod.job)
        ]

    def _loop_closure(self, ctx: ScheduleContext, view: LinkView, pod: Task,
                      node_name: str) -> Tuple[bool, List[str]]:
        """Per-candidate dependency-loop closure, computed once per Score
        phase (score_nodes pre-computes it; a direct score() call fills the
        same per-context slot).  The candidate-independent contending pairs
        are shared across candidates via the context."""
        store = ctx.cache.setdefault("loop_closure", {})
        if node_name not in store:
            base = ctx.cache.get("base_pairs")
            if base is None:
                base_view = LinkView(view.cluster, view._tasks)
                base = {l: base_view.contending_pairs(l)
                        for l in base_view.planning_links()}
                ctx.cache["base_pairs"] = base
            store[node_name] = self._dependency_loop_closure(view, pod, base)
        return store[node_name]

    def score(self, ctx: ScheduleContext, cluster: Cluster, pod: Task,
              node_name: str, registry: TaskRegistry) -> float:
        schemes: Dict[str, Dict[str, LinkScheme]] = ctx.cache.setdefault(
            "schemes", {})
        rot_scores: Dict[str, float] = ctx.cache.setdefault("rot_score", {})

        # early return 1: LowComm pod — communication need not be guaranteed
        if pod.low_comm:
            ctx.cache.setdefault("early", {})[node_name] = True
            rot_scores[node_name] = PERFECT
            return PERFECT

        # the planner's fast feasible path over every link the placement
        # would traverse: host link + uplinks, solved per link and resolved
        # jointly when the per-link solutions conflict; the node's
        # bandwidth score is the worst link score
        view = self._candidate_view(cluster, pod, node_name, registry)
        links = self._candidate_links(cluster, view, pod, node_name)
        plan = rotation.plan(
            view, registry, links=links, self_job=pod.job, mode="fast",
            demand="planning", di_pre=self.di_pre, g_t_ms=self.g_t_ms,
            e_t_frac=self.e_t_frac, rotation_mode=self.rotation_mode,
            joint=self.joint, cache=self.plan_cache,
        )
        link_schemes = plan.schemes
        worst = plan.score

        if not link_schemes:
            # no contention on any traversed link — still prefer intra-leaf
            # placements before any uplink rotation is even needed
            ctx.cache.setdefault("early", {})[node_name] = True
            rot_scores[node_name] = PERFECT
            return (PERFECT - self._rack_penalty(view, pod)
                    - self._fluct_penalty(cluster, view, pod, node_name))

        # cross-link dependency loop: the per-link rotations cannot be made
        # globally consistent by offset translation alone.  With the joint
        # planner the cycle is SOLVABLE: re-plan over the affinity
        # component's full link closure and let the joint score speak (a
        # genuinely infeasible cycle scores below perfect by itself).  In
        # legacy mode (joint=False) keep the old cap below perfect so
        # loop-free placements win ties.  The schemes keep the RAW rotation
        # scores either way: the controller's realign guard needs to know
        # whether an interleave actually exists on each link.
        loop, closure = self._loop_closure(ctx, view, pod, node_name)
        if loop:
            if self.joint:
                wanted = set(closure) | set(links)
                plan_links = [l for l in view.planning_links() if l in wanted]
                jplan = rotation.plan(
                    view, registry, links=plan_links,
                    self_job=pod.job, mode="fast", demand="planning",
                    di_pre=self.di_pre, g_t_ms=self.g_t_ms,
                    e_t_frac=self.e_t_frac, rotation_mode=self.rotation_mode,
                    joint=True, cache=self.plan_cache,
                )
                if jplan.schemes:
                    link_schemes = jplan.schemes
                    worst = jplan.score
            else:
                worst = min(worst, 99.0)

        schemes[node_name] = link_schemes
        ctx.cache.setdefault("early", {})[node_name] = False
        # the raw rotation score drives SkipPhaseThree (Reserve); the rack
        # penalty only demotes the NODE choice
        rot_scores[node_name] = float(worst)
        return float(max(0.0, worst - self._rack_penalty(view, pod)
                         - self._fluct_penalty(cluster, view, pod,
                                               node_name)))

    def score_nodes(self, ctx: ScheduleContext, cluster: Cluster, pod: Task,
                    nodes: List[str],
                    registry: TaskRegistry) -> Dict[str, float]:
        """Score every surviving candidate in one batched pass.

        A pre-pass mirrors :meth:`score`'s planning decisions per candidate
        — per-link solves (memoized, so a link untouched by the candidate
        delta is solved ONCE for all N candidates) and the dependency-loop
        closure analysis — then hands EVERY conflicted component of every
        candidate to :func:`rotation.joint_solve_batch`, which scores each
        problem family's whole combo space in shared batched evaluations
        (one stacked (C, L, R, S) kernel dispatch under
        ``backend='kernel'``).  The per-candidate :meth:`score` calls that
        follow hit the warmed cache, so results are bit-for-bit those of
        the sequential path."""
        if (self.plan_cache is not None and self.joint and not pod.low_comm
                and len(nodes) > 1):
            self._warm_candidates(ctx, cluster, pod, nodes, registry)
        return {n: self.score(ctx, cluster, pod, n, registry)
                for n in nodes}

    def _warm_candidates(self, ctx: ScheduleContext, cluster: Cluster,
                         pod: Task, nodes: List[str],
                         registry: TaskRegistry) -> None:
        """Collect every per-link AND joint problem the per-candidate Score
        pass will solve and batch-solve them into the plan cache.

        Stage 1 gathers the per-link solves of every loop candidate and
        hands them to :func:`rotation.solve_link_batch` — one shared
        enumeration pass per problem family (candidates repeat the same
        link problems away from their delta, so families are large).
        Stage 2 walks the solved schemes' conflicted components into
        :func:`rotation.joint_solve_batch` exactly as before."""
        cand = []
        link_specs = []
        for node_name in nodes:
            view = self._candidate_view(cluster, pod, node_name, registry)
            links = self._candidate_links(cluster, view, pod, node_name)
            loop, closure = self._loop_closure(ctx, view, pod, node_name)
            if not loop:
                continue
            wanted = set(closure) | set(links)
            plan_links = [l for l in view.planning_links() if l in wanted]
            cand.append((view, plan_links))
            link_specs.extend((view, lid) for lid in plan_links)
        if not cand:
            return
        solved = rotation.solve_link_batch(
            link_specs, registry, self_job=pod.job, mode="fast",
            demand="planning", di_pre=self.di_pre, g_t_ms=self.g_t_ms,
            e_t_frac=self.e_t_frac, rotation_mode=self.rotation_mode,
            cache=self.plan_cache,
        )
        specs = []
        pos = 0
        for view, plan_links in cand:
            schemes: Dict[str, LinkScheme] = {}
            for lid in plan_links:
                _score, scheme = solved[pos]
                pos += 1
                if scheme is not None:
                    schemes[lid] = scheme
            if len(schemes) < 2:
                continue  # plan() will not resolve, nothing joint to warm
            for comp_links, conflicted in rotation.conflicted_components(
                    schemes, self.di_pre):
                if conflicted:
                    specs.append((view, comp_links))
        if specs:
            rotation.joint_solve_batch(
                specs, registry, mode="fast", demand="planning",
                rotation_mode=self.rotation_mode, di_pre=self.di_pre,
                g_t_ms=self.g_t_ms, e_t_frac=self.e_t_frac,
                cache=self.plan_cache,
            )

    def _fluct_penalty(self, cluster: Cluster, view: LinkView, pod: Task,
                       node_name: str) -> float:
        """Reconfiguration-aware Score penalty: worst observed-fluctuation
        CV over the links the candidate placement would traverse, scaled
        by ``FLUCTUATION_PENALTY_SCALE``.  Exactly 0.0 on a plain
        :class:`Cluster` (no ``fluctuation`` history — the oracle path),
        so the seed's scores are untouched bit-for-bit."""
        fluct = getattr(cluster, "fluctuation", None)
        if fluct is None:
            return 0.0
        worst = 0.0
        for l in self._candidate_links(cluster, view, pod, node_name):
            worst = max(worst, fluct(l))
        return FLUCTUATION_PENALTY_SCALE * min(1.0, worst)

    def _rack_penalty(self, view: LinkView, pod: Task) -> float:
        """Rack-locality Score bonus (inverted as a penalty): demote
        candidates that make the pod's job traverse a spine uplink.  When
        the job spans leaves regardless of this pod, every candidate pays
        equally and the preference is a no-op; on star topologies no uplink
        exists and the penalty is always zero."""
        if view.traversed_uplinks(pod.job):
            return RACK_LOCALITY_PENALTY
        return 0.0

    # -------------------------------------------------------- NormalizeScore
    def normalize_scores(self, ctx: ScheduleContext, cluster: Cluster, pod: Task,
                         scores: Dict[str, float],
                         registry: TaskRegistry) -> Dict[str, float]:
        max_score = max(scores.values())
        ctx.cache["max_score"] = max_score
        candidates = [n for n, s in scores.items() if s >= max_score - 1e-9]
        if len(candidates) == 1:
            return scores
        # 2nd optimization stage: Eq. 19 reverse-mapped latency among the
        # bandwidth-optimal candidates; all other nodes are zeroed.
        delta = ctx.cache["delta"]
        dvals = [delta[n] for n in candidates]
        dmin, dmax = min(dvals), max(dvals)
        out = {n: 0.0 for n in scores}
        for n in candidates:
            if dmax != dmin:
                norm = 100.0 - math.floor(100.0 * (delta[n] - dmin) / (dmax - dmin))
            else:
                norm = 100.0 - (delta[n] - dmin)
            if pod.low_comm:
                # LowComm pods take the WORST network location
                out[n] = 100.0 - norm
            else:
                out[n] = norm
        return out

    # ---------------------------------------------------------------- Reserve
    def reserve(self, ctx: ScheduleContext, cluster: Cluster, pod: Task,
                node_name: str, registry: TaskRegistry) -> None:
        all_schemes: Dict[str, Dict[str, LinkScheme]] = ctx.cache.get(
            "schemes", {})
        early = ctx.cache.get("early", {}).get(node_name, True)
        # the raw (pre-rack-penalty) rotation scores decide SkipPhaseThree;
        # the best candidate's raw score says whether contention was
        # avoidable at all
        rot_scores = ctx.cache.get("rot_score", {})
        max_score = max(rot_scores.values()) if rot_scores else PERFECT
        link_schemes = {} if early else all_schemes.get(node_name, {})

        # per-link SkipPhaseThree (Alg. 1): skip when the best node is
        # imperfect (unavoidable contention) or the link carries only 2 jobs
        # (the intermediate rotation is already optimal)
        skips: Dict[str, bool] = {}
        for link_id, scheme in link_schemes.items():
            skips[link_id] = bool(
                max_score < PERFECT - 1e-9 or len(scheme.jobs) == 2
            )
        skip = bool(early or all(skips.values()))

        shifts_ms: Dict[str, float] = {}
        host_scheme = link_schemes.get(node_name)
        if host_scheme is not None:
            delays = geometry.shifts_to_delay_ms(
                host_scheme.shifts_slots, host_scheme.base_ms, self.di_pre
            )
            shifts_ms = {j: float(d) for j, d in zip(host_scheme.jobs, delays)}

        msg = ReserveMessage(node=node_name, schemes=link_schemes,
                             shifts_ms=shifts_ms, skip_phase_three=skip,
                             skips=skips)
        self.messages.append(msg)
        if self.controller is not None:
            self.controller.on_schedule(cluster, registry, msg)

    def unreserve(self, cluster: Cluster, pod: Task, node_name: str,
                  registry: TaskRegistry) -> None:
        if self.controller is not None:
            self.controller.on_evict(node_name, pod, registry=registry,
                                     cluster=cluster)
