"""A minimal K8s-scheduling-framework analogue (extension points + cycle).

The paper registers custom logic at PreFilter / Filter / Score /
NormalizeScore / Reserve of the K8s scheduling framework (v0.26.7). We keep
the same extension points and pod-by-pod scheduling cycle, plus the
Coscheduling (all-or-nothing, Eqs. 11-12) gate at the job level.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .cluster import Cluster
from .workload import Job, Task, Workload


@dataclasses.dataclass
class ScheduleContext:
    """Per-cycle scratch space shared across extension points (the paper's
    PreFilter 'CacheResource' lives here)."""

    cache: Dict = dataclasses.field(default_factory=dict)


class SchedulerPlugin:
    """Extension-point interface. Plugins override what they need."""

    name = "base"

    def pre_filter(self, ctx: ScheduleContext, cluster: Cluster, pod: Task,
                   registry: "TaskRegistry") -> None:
        return None

    def filter(self, ctx: ScheduleContext, cluster: Cluster, pod: Task,
               node_name: str, registry: "TaskRegistry") -> bool:
        return True

    def score(self, ctx: ScheduleContext, cluster: Cluster, pod: Task,
              node_name: str, registry: "TaskRegistry") -> float:
        return 0.0

    def score_nodes(self, ctx: ScheduleContext, cluster: Cluster, pod: Task,
                    nodes: List[str],
                    registry: "TaskRegistry") -> Dict[str, float]:
        """Score every feasible node of one pod.  The default simply loops
        :meth:`score`; plugins may override to batch the per-candidate work
        (Metronome solves all candidates' rotation problems in one pass)."""
        return {n: self.score(ctx, cluster, pod, n, registry) for n in nodes}

    def normalize_scores(self, ctx: ScheduleContext, cluster: Cluster, pod: Task,
                         scores: Dict[str, float],
                         registry: "TaskRegistry") -> Dict[str, float]:
        return scores

    def reserve(self, ctx: ScheduleContext, cluster: Cluster, pod: Task,
                node_name: str, registry: "TaskRegistry") -> None:
        return None

    def unreserve(self, cluster: Cluster, pod: Task, node_name: str,
                  registry: "TaskRegistry") -> None:
        return None


class TaskRegistry:
    """Cluster-wide view of deployed tasks (the operators' CR store)."""

    def __init__(self) -> None:
        self.tasks: Dict[str, Task] = {}
        self.jobs: Dict[str, Job] = {}
        self.workloads: Dict[str, Workload] = {}
        # monotonic mutation counter: advanced on every task/job store
        # change AND on in-place task mutations (traffic changes), so the
        # (cluster.epoch, registry.epoch) pair tags a LinkView snapshot for
        # sound planner-cache invalidation (DESIGN.md section 15)
        self.epoch: int = 0

    def bump(self) -> None:
        """Advance the mutation epoch (see :class:`~repro_torch.core.rotation.
        PlanCache`); every mutation of stored tasks/jobs must call this."""
        self.epoch += 1

    def deployed_on(self, node_name: str) -> List[Task]:
        return [t for t in self.tasks.values() if t.node == node_name]

    def job_tasks(self, job_name: str) -> List[Task]:
        return [t for t in self.tasks.values() if t.job == job_name]

    def dependencies_of(self, pod: Task) -> List[Task]:
        """Dependent pods: explicit AppGroup deps + all pods of the same job
        (the paper auto-treats same-job pods as dependent)."""
        deps: Dict[str, Task] = {}
        for t in self.tasks.values():
            if t.uid == pod.uid:
                continue
            if t.job == pod.job:
                deps[t.uid] = t
        wl = self.workloads.get(pod.workload)
        if wl is not None:
            for a, b in wl.dependencies:
                other = None
                if a == pod.job:
                    other = b
                elif b == pod.job:
                    other = a
                if other is not None:
                    for t in self.job_tasks(other):
                        deps[t.uid] = t
        return list(deps.values())


@dataclasses.dataclass
class ScheduleOutcome:
    pod: Task
    node: Optional[str]  # None -> unschedulable
    score: float = 0.0


class SchedulingFramework:
    """Runs the scheduling cycle for one pod and all-or-nothing for jobs."""

    def __init__(self, cluster: Cluster, plugin: SchedulerPlugin):
        self.cluster = cluster
        self.plugin = plugin
        self.registry = TaskRegistry()

    # -- single pod cycle ---------------------------------------------------
    def schedule_pod(self, pod: Task) -> ScheduleOutcome:
        ctx = ScheduleContext()
        self.plugin.pre_filter(ctx, self.cluster, pod, self.registry)

        feasible = [
            n for n in self.cluster.node_names
            if self._spread_ok(pod, n)
            and self.plugin.filter(ctx, self.cluster, pod, n, self.registry)
        ]
        if not feasible:
            return ScheduleOutcome(pod, None)

        scores = self.plugin.score_nodes(ctx, self.cluster, pod, feasible,
                                         self.registry)
        scores = self.plugin.normalize_scores(ctx, self.cluster, pod, scores,
                                              self.registry)
        # deterministic tie-break on node order
        best = max(scores.items(), key=lambda kv: (kv[1], -self.cluster.index(kv[0])))
        node_name = best[0]
        pod.node = node_name
        self.cluster.node(node_name).allocate(pod.uid, pod.resources,
                                              pod.traffic.bw_gbps)
        self.registry.tasks[pod.uid] = pod
        # the demand view changed: advance the epochs BEFORE Reserve so the
        # controller's replan (and any later Score) sees a fresh snapshot
        self.cluster.bump_epoch()
        self.registry.bump()
        self.plugin.reserve(ctx, self.cluster, pod, node_name, self.registry)
        return ScheduleOutcome(pod, node_name, best[1])

    def _spread_ok(self, pod: Task, node_name: str) -> bool:
        """PodTopologySpread: cap same-job pods per node (pod-spec level —
        honored by every scheduler, like a K8s spread constraint)."""
        if pod.spread <= 0:
            return True
        same = sum(
            1 for t in self.registry.tasks.values()
            if t.job == pod.job and t.node == node_name
        )
        return same < pod.spread

    # -- all-or-nothing job gate (Coscheduling; Eqs. 11-12) ------------------
    def schedule_job(self, job: Job) -> bool:
        self.registry.jobs[job.name] = job
        self.registry.bump()
        placed: List[Task] = []
        for pod in job.tasks:
            out = self.schedule_pod(pod)
            if out.node is None:
                # roll back the whole job (all-or-nothing), registry entry
                # included — a failed attempt must leave no phantom job
                # behind, or every scorer that walks registry.jobs pays for
                # it on all later admissions (and a retried online queue
                # leaks one phantom per failed attempt)
                for t in placed:
                    self.evict_pod(t)
                self.registry.jobs.pop(job.name, None)
                self.registry.bump()
                return False
            placed.append(pod)
        return True

    def schedule_workload(self, wl: Workload) -> bool:
        self.registry.workloads[wl.name] = wl
        self.registry.bump()
        placed_jobs: List[Job] = []
        for job in wl.jobs:
            if not self.schedule_job(job):
                for j in placed_jobs:
                    self.evict_job(j)
                self.registry.workloads.pop(wl.name, None)
                self.registry.bump()
                return False
            placed_jobs.append(job)
        return True

    # -- teardown ------------------------------------------------------------
    def evict_pod(self, pod: Task) -> None:
        if pod.node is not None:
            self.cluster.node(pod.node).release(pod.uid, pod.resources)
            self.cluster.bump_epoch()
            self.plugin.unreserve(self.cluster, pod, pod.node, self.registry)
            pod.node = None
        self.registry.tasks.pop(pod.uid, None)
        self.registry.bump()

    def evict_job(self, job: Job) -> None:
        for t in job.tasks:
            self.evict_pod(t)
        self.registry.jobs.pop(job.name, None)
        self.registry.bump()
