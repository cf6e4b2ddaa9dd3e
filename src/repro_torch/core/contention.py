"""Unified link-contention view — the single authority for job→link demand.

Before this module existed the bookkeeping of "which jobs place how much
demand on which fabric link" was implemented three times with subtly
different rules: the scheduler's ``_node_jobs``/``_uplink_jobs``/
``_traversed_uplinks``, the controller's ``_link_traffic``, and the
simulator's ``_job_links``/``_make_flows``.  :class:`LinkView` replaces all
three (DESIGN.md section 9).  It is built from ``(Cluster, task store,
optional candidate pod@node)`` and answers, for every link id (host link ==
node name, spine uplinks ``uplink:<leaf>``):

  * the job → tasks grouping that sources traffic onto the link,
  * per-job demand (Gbps) and the duty/period inputs of the rotation solve,
  * the contending-pair predicate of Eq. 9 (combined demand exceeding the
    link's allocatable bandwidth),
  * the fluid simulator's flow specification (source host link + full path).

Two demand conventions intentionally coexist and are both served from this
one view:

  * the **planning view** (:meth:`host_groups` / :meth:`uplink_groups`) is
    what the scheduler's Filter/Score and the dependency-loop filter see:
    LowComm pods are excluded and a co-located job's tasks count against its
    host link even when the job is single-node (conservative — Eq. 17 ties
    all tasks of a job to one rotation);
  * the **flow view** (:meth:`flows_for`) is the fluid simulator's model:
    single-node jobs synchronize over localhost and place no link traffic,
    and demand aggregates per source host link.

The controller's offline recalculation keeps its legacy whole-job host-link
demand (:meth:`recalc_traffic` / :meth:`recalc_demands`).  Since the
fabric-wide rotation planner became the single producer of schemes
(``core/rotation.py``), this divergence is an explicit, named *demand
convention* of the planner (``demand='planning'`` vs ``demand='recalc'``)
rather than two code paths: the Score phase plans with the planning view,
the offline 3rd stage re-solves with the recalc view, and both read the
same grouped tasks from this one class (DESIGN.md section 13).  Folding the
host rule into the planning view would re-scale Eq. 18's excess on every
star recalculation and is pinned out by the seed goldens.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .cluster import Cluster
from .topology import is_uplink
from .workload import Job, Task, TrafficSpec

EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class FlowSpec:
    """One fluid flow of a job: source host link, demand, full link path."""

    node: str
    demand_gbps: float
    links: Tuple[str, ...]


def group_demand_gbps(tasks: Sequence[Task]) -> float:
    """Aggregate link demand of one job's grouped tasks."""
    return sum(t.traffic.bw_gbps for t in tasks)


class LinkView:
    """Authoritative job→link demand view over a cluster + task store.

    ``extra``/``extra_node`` model a *candidate* placement: the scheduler
    scores pod ``extra`` as if it were already deployed on ``extra_node``
    (the pod's real ``node`` stays ``None`` until Reserve).

    Groupings preserve task-store iteration order (registry insertion
    order) so downstream consumers — rotation job order, networkx edge
    insertion, max-min-fair tie-breaks — are bit-for-bit reproducible.

    ``epoch`` tags the snapshot this view was built from (DESIGN.md
    section 15): :meth:`from_registry` captures the monotonic
    ``(cluster.epoch, registry.epoch)`` mutation counters, which advance on
    every reserve/unreserve, traffic change, and capacity/background event.
    Downstream planner caches (:class:`repro_torch.core.rotation.PlanCache`) key
    on it, so reusing a result across ANY mutation is impossible by
    construction.  Views built without an epoch (``epoch=None``) disable
    caching entirely.
    """

    def __init__(self, cluster: Cluster, tasks: Sequence[Task] = (), *,
                 extra: Optional[Task] = None,
                 extra_node: Optional[str] = None,
                 epoch: Optional[Tuple[int, int]] = None) -> None:
        self.cluster = cluster
        self._tasks: List[Task] = list(tasks)
        self.extra = extra
        self.extra_node = extra_node
        self.epoch = epoch
        self._job_nodes_cache: Optional[Dict[str, Set[str]]] = None
        # flows_for(cache_epoch=...) memo: job name -> (epoch, specs)
        self._flows_cache: Dict[str, Tuple[int, List["FlowSpec"]]] = {}

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_registry(cls, cluster: Cluster, registry, *,
                      extra: Optional[Task] = None,
                      extra_node: Optional[str] = None) -> "LinkView":
        """View over the deployed tasks of a :class:`TaskRegistry`, tagged
        with the current (cluster, registry) mutation epoch."""
        reg_epoch = getattr(registry, "epoch", None)
        cl_epoch = getattr(cluster, "epoch", None)
        epoch = (None if reg_epoch is None or cl_epoch is None
                 else (cl_epoch, reg_epoch))
        return cls(cluster, list(registry.tasks.values()), extra=extra,
                   extra_node=extra_node, epoch=epoch)

    # ---------------------------------------------------------------- plumbing
    def job_tasks(self, job: str) -> List[Task]:
        """All stored tasks of ``job`` in store (registry-insertion) order."""
        return [t for t in self._tasks if t.job == job]

    def _job_nodes(self) -> Dict[str, Set[str]]:
        """job -> set of nodes it occupies (candidate placement included)."""
        if self._job_nodes_cache is None:
            out: Dict[str, Set[str]] = {}
            for t in self._tasks:
                if t.node is not None:
                    out.setdefault(t.job, set()).add(t.node)
            if self.extra is not None and self.extra_node is not None:
                out.setdefault(self.extra.job, set()).add(self.extra_node)
            self._job_nodes_cache = out
        return self._job_nodes_cache

    def _uplink_leaf(self, link_id: str) -> Optional[str]:
        """Leaf owning ``link_id`` when it is an uplink, else None."""
        if not is_uplink(link_id):
            return None
        for leaf, up in self.cluster.topology.uplinks.items():
            if up.id == link_id:
                return leaf
        return None

    # ------------------------------------------------------------ planning view
    def host_groups(self, node_name: str) -> Dict[str, List[Task]]:
        """Jobs sourcing traffic onto ``node_name``'s host link -> their
        tasks there (LowComm pods excluded; Eq. 17 ties a job's co-located
        tasks to a single rotation)."""
        groups: Dict[str, List[Task]] = {}
        for t in self._tasks:
            if t.node == node_name and not t.low_comm:
                groups.setdefault(t.job, []).append(t)
        if (self.extra is not None and self.extra_node == node_name
                and not self.extra.low_comm):
            groups.setdefault(self.extra.job, []).append(self.extra)
        return groups

    def uplink_groups(self, leaf: str) -> Dict[str, List[Task]]:
        """Jobs traversing ``leaf``'s uplink -> their in-leaf tasks.

        A job crosses the uplink when it has pods both inside and outside
        the leaf; its uplink demand is the aggregate bandwidth its IN-leaf
        pods source toward the spine (the simulator's flow model)."""
        topo = self.cluster.topology
        groups: Dict[str, List[Task]] = {}
        for job, nodes in self._job_nodes().items():
            if not topo.spans_leaves(nodes):
                continue
            if not any(topo.leaf_of[n] == leaf for n in nodes):
                continue
            in_leaf = [
                t for t in self.job_tasks(job)
                if t.node is not None and topo.leaf_of[t.node] == leaf
                and not t.low_comm
            ]
            if (self.extra is not None and self.extra_node is not None
                    and self.extra.job == job and not self.extra.low_comm
                    and topo.leaf_of[self.extra_node] == leaf
                    and all(t.uid != self.extra.uid for t in in_leaf)):
                in_leaf = in_leaf + [self.extra]
            if in_leaf:
                groups[job] = in_leaf
        return groups

    def link_groups(self, link_id: str) -> Dict[str, List[Task]]:
        """Dispatch: host link (id == node name) or ``uplink:<leaf>``."""
        leaf = self._uplink_leaf(link_id)
        if leaf is not None:
            return self.uplink_groups(leaf)
        return self.host_groups(link_id)

    def demands(self, link_id: str) -> Dict[str, float]:
        """job -> aggregate demand (Gbps) on one link, in grouping order."""
        return {j: group_demand_gbps(ts)
                for j, ts in self.link_groups(link_id).items()}

    # --------------------------------------------------------- Eq. 9 predicate
    def contending_pairs(self, link_id: str) -> List[Tuple[str, str]]:
        """Job pairs whose combined demand exceeds the link's allocatable
        bandwidth (Eq. 9's criterion) — only these constrain relative
        rotations; sub-capacity co-location imposes nothing.  Pair order
        follows the grouping order (i < j)."""
        groups = self.link_groups(link_id)
        jobs = list(groups.keys())
        bws = {j: group_demand_gbps(ts) for j, ts in groups.items()}
        cap = self.cluster.link_alloc(link_id)
        out: List[Tuple[str, str]] = []
        for i in range(len(jobs)):
            for j in range(i + 1, len(jobs)):
                a, b = jobs[i], jobs[j]
                if bws[a] + bws[b] > cap:
                    out.append((a, b))
        return out

    def contends(self, link_id: str, job_a: str, job_b: str) -> bool:
        """Eq. 9 predicate for one pair on one link."""
        bws = self.demands(link_id)
        return (bws.get(job_a, 0.0) + bws.get(job_b, 0.0)
                > self.cluster.link_alloc(link_id))

    def planning_links(self) -> List[str]:
        """Every link id in the canonical traversal order: host links (node
        order), then uplinks (topology order) — the loop-filter and the
        controller's deterministic tie-break both rely on it."""
        return list(self.cluster.node_names) + self.cluster.topology.uplink_ids

    # ------------------------------------------------------------------ routing
    def traversed_uplinks(self, job: str) -> List[str]:
        """Leaves whose uplinks ``job`` traverses under the current (plus
        candidate) placement; empty on star topologies or intra-leaf jobs."""
        topo = self.cluster.topology
        if topo.is_star:
            return []
        nodes = self._job_nodes().get(job, set())
        if not nodes or not topo.spans_leaves(nodes):
            return []
        return sorted({topo.leaf_of[n] for n in nodes}
                      & set(topo.uplinks.keys()))

    # ---------------------------------------------------------------- flow view
    def flows_for(self, job: Job, *,
                  cache_epoch: Optional[int] = None) -> List[FlowSpec]:
        """The fluid simulator's flow construction: one flow per used host
        link (aggregate of the job's pods there); the path extends over the
        source leaf's uplink when the job spans leaves.  Single-node jobs
        synchronize over localhost and place no link traffic.

        ``cache_epoch`` (the simulator's event loop passes ``cluster.epoch``)
        memoizes the specs per job until the epoch advances: a job's flow
        set depends only on its own placements and per-task bandwidths, and
        every mutation of either — reserve/release, departures — bumps the
        cluster epoch, so the steady-state COMM entries of a long trace skip
        the per-task rebuild.  Duty-cycle traffic changes alter volumes (the
        caller's ``comm_ms``), never these demands/paths."""
        if cache_epoch is not None:
            hit = self._flows_cache.get(job.name)
            if hit is not None and hit[0] == cache_epoch:
                return hit[1]
        specs = self._flows_for_uncached(job)
        if cache_epoch is not None:
            self._flows_cache[job.name] = (cache_epoch, specs)
        return specs

    def _flows_for_uncached(self, job: Job) -> List[FlowSpec]:
        nodes = job.nodes_used()
        if len(nodes) <= 1:
            return []
        topo = self.cluster.topology
        agg: Dict[str, float] = {}
        for t in job.tasks:
            if t.node is None or t.traffic.bw_gbps <= 0:
                continue
            agg[t.node] = agg.get(t.node, 0.0) + t.traffic.bw_gbps
        return [FlowSpec(n, bw, topo.flow_links(n, nodes))
                for n, bw in agg.items()]

    def fill_problem(self, jobs: Sequence[Job]):
        """The (flows x links) fill-problem inputs of the fluid engine
        (``core/fluid.py``) for the given jobs' placements: per-flow demands
        and link paths from :meth:`flows_for`, plus the allocatable capacity
        of every link any path crosses.  Returns ``(demands, paths, caps)``
        ready for ``fluid.fill_python`` / ``fluid.problem_matrix`` — the
        construction path of the production-trace throughput benchmark and
        the backend-parity tests."""
        demands: List[float] = []
        paths: List[Tuple[str, ...]] = []
        for job in jobs:
            for fs in self.flows_for(job):
                demands.append(fs.demand_gbps)
                paths.append(fs.links)
        caps: Dict[str, float] = {}
        for p in paths:
            for l in p:
                if l not in caps:
                    caps[l] = self.cluster.link_alloc(l)
        return demands, paths, caps

    # -------------------------------------------------- controller recalc inputs
    def recalc_traffic(self, link_id: str, jobs: Sequence[str],
                       muls, base_ms: float
                       ) -> Tuple[List[float], List[float]]:
        """(duties, bws) inputs for the offline 3rd-stage recalculation of
        one link scheme (jobs/muls/base_ms come from the scheme).

        Uplinks use the in-leaf grouping (matching :meth:`uplink_groups`).
        Host links keep the controller's legacy whole-job convention — the
        sum over ALL deployed tasks of the job, not only those on this node
        (see :meth:`recalc_demands`)."""
        duties: List[float] = []
        for idx, j in enumerate(jobs):
            tasks = self.job_tasks(j)
            spec = tasks[0].traffic if tasks else TrafficSpec(100.0, 0.3, 1.0)
            eff_period = base_ms / max(int(muls[idx]), 1)
            duties.append(min(1.0, spec.comm_ms / eff_period))
        return duties, self.recalc_demands(link_id, jobs)

    def recalc_demands(self, link_id: str, jobs: Sequence[str]) -> List[float]:
        """Per-job demand (Gbps) under the offline-recalculation convention.

        Uplinks: the in-leaf aggregate (identical to the planning view).
        Host links: the sum over ALL deployed tasks of the job — the
        controller's legacy whole-job rule, deliberately preserved: the
        star-topology seed goldens pin the recalculated shifts bit-for-bit
        against it (DESIGN.md section 13 documents the divergence)."""
        topo = self.cluster.topology
        leaf = self._uplink_leaf(link_id)
        bws: List[float] = []
        for j in jobs:
            tasks = self.job_tasks(j)
            if leaf is None:
                bws.append(sum(t.traffic.bw_gbps for t in tasks
                               if t.node is not None))
            else:
                bws.append(sum(t.traffic.bw_gbps for t in tasks
                               if t.node is not None and not t.low_comm
                               and topo.leaf_of[t.node] == leaf))
        return bws

    # ----------------------------------------------------- reconfiguration view
    def expected_iteration_ms(self, job: str) -> Optional[float]:
        """Contention-free iteration time under the CURRENT allocatable
        bandwidths — the reconfiguration engine's baseline (DESIGN.md
        section 10).  When a link's allocatable share drops below the job's
        demand, even a perfectly rotated communication phase stretches by
        ``demand / allocatable``; the stop-and-wait monitor must not fight
        that unavoidable slowdown as if it were drift.  Uses the flow view
        (single-node jobs never touch a link) with per-leaf aggregation on
        traversed uplinks.  Returns None when the job is unknown."""
        tasks = self.job_tasks(job)
        if not tasks:
            return None
        spec = tasks[0].traffic
        nodes = sorted({t.node for t in tasks if t.node is not None})
        stretch = 1.0
        if len(nodes) > 1:
            agg: Dict[str, float] = {}
            for t in tasks:
                if t.node is None or t.traffic.bw_gbps <= 0:
                    continue
                agg[t.node] = agg.get(t.node, 0.0) + t.traffic.bw_gbps
            for n, d in agg.items():
                alloc = self.cluster.link_alloc(n)
                if alloc > EPS:
                    stretch = max(stretch, d / alloc)
            topo = self.cluster.topology
            for leaf in self.traversed_uplinks(job):
                up = topo.uplinks[leaf]
                d = group_demand_gbps(self.uplink_groups(leaf).get(job, []))
                # read through the cluster's link API (not the raw Link
                # object) so a TelemetryView proxy observes the uplink's
                # allocatable share like every other consumer
                alloc = self.cluster.link_alloc(up.id)
                if alloc > EPS:
                    stretch = max(stretch, d / alloc)
        return spec.compute_ms + spec.comm_ms * stretch
