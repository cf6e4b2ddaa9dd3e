"""Workload hierarchy: workload -> job -> task(pod), plus traffic specs.

Mirrors the paper's CRDs:
  - PodBandwidth -> :class:`TrafficSpec` (period t_p, duty cycle d_p, r_p^BW)
  - AppGroup     -> :class:`Workload.dependencies` (nu_w)

Priorities: the paper defines two levels (high/low) assigned via pod labels.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Tuple

from .cluster import Resources

HIGH = 1
LOW = 0

_uid_counter = itertools.count()


@dataclasses.dataclass
class TrafficSpec:
    """Periodic on-off traffic pattern of one task (PodBandwidth CR).

    period_ms : iteration time t_p under contention-free conditions.
    duty      : communication duty cycle d_p in [0, 1].
    bw_gbps   : bandwidth demand r_p^BW during the communication phase.
    """

    period_ms: float
    duty: float
    bw_gbps: float

    @property
    def comm_ms(self) -> float:
        """m_p = t_p * d_p — communication duration per iteration."""
        return self.period_ms * self.duty

    @property
    def compute_ms(self) -> float:
        return self.period_ms - self.comm_ms

    @property
    def low_comm(self) -> bool:
        """LowComm pods declare no bandwidth requirement (paper section III-B)."""
        return self.bw_gbps <= 0.0 or self.duty <= 0.0


@dataclasses.dataclass
class Task:
    """One pod of a distributed training job."""

    uid: str
    job: str
    workload: str
    resources: Resources
    traffic: TrafficSpec
    priority: int = LOW
    node: Optional[str] = None  # assigned by the scheduler
    # time-shift (ms) of the communication phase, assigned by the controller
    shift_ms: float = 0.0
    # PodTopologySpread: max pods of this job per node (0 = unlimited)
    spread: int = 0

    @property
    def low_comm(self) -> bool:
        return self.traffic.low_comm


@dataclasses.dataclass
class Job:
    """A distributed training job = a set of synchronized parallel tasks."""

    name: str
    workload: str
    tasks: List[Task]
    priority: int = LOW
    n_iterations: int = 1000
    submit_time_s: float = 0.0
    model: str = ""  # ML model name (VGG19, BERT, ...)

    @property
    def traffic(self) -> TrafficSpec:
        return self.tasks[0].traffic

    def nodes_used(self) -> List[str]:
        return sorted({t.node for t in self.tasks if t.node is not None})

    def spans_multiple_nodes(self) -> bool:
        return len(self.nodes_used()) > 1


@dataclasses.dataclass
class Workload:
    """User submission: possibly several jobs (e.g. HPO sweep) + deps nu_w."""

    name: str
    jobs: List[Job]
    # nu_w: (job_a, job_b) pairs with inter-job dependencies
    dependencies: List[Tuple[str, str]] = dataclasses.field(default_factory=list)

    def all_tasks(self) -> List[Task]:
        return [t for j in self.jobs for t in j.tasks]


def make_job(
    name: str,
    *,
    n_tasks: int,
    period_ms: float,
    duty: float,
    bw_gbps: float,
    priority: int = LOW,
    resources: Optional[Resources] = None,
    workload: str = "",
    n_iterations: int = 1000,
    submit_time_s: float = 0.0,
    model: str = "",
    spread: int = 1,
) -> Job:
    """Convenience constructor for a DP training job with uniform tasks.

    ``spread`` mirrors K8s PodTopologySpread (Kubeflow jobs spread workers
    across nodes); 0 disables the constraint.
    """
    workload = workload or name
    resources = resources or Resources(cpu=5, mem=5, gpu=1)
    tasks = []
    for i in range(n_tasks):
        uid = f"{name}/task-{i}"
        tasks.append(
            Task(
                uid=uid,
                job=name,
                workload=workload,
                resources=dataclasses.replace(resources),
                traffic=TrafficSpec(period_ms, duty, bw_gbps),
                priority=priority,
                spread=spread,
            )
        )
    return Job(
        name=name,
        workload=workload,
        tasks=tasks,
        priority=priority,
        n_iterations=n_iterations,
        submit_time_s=submit_time_s,
        model=model,
    )


def traffic_from_roofline(
    step_compute_s: float,
    step_collective_s: float,
    bw_gbps: float,
) -> TrafficSpec:
    """Derive a Metronome TrafficSpec from roofline terms of a compiled step.

    This is the bridge between the JAX training substrate and the scheduler:
    period = full step time, duty = collective fraction (the sync phase the
    paper interleaves), bandwidth = the job's DCN demand.
    """
    period_ms = (step_compute_s + step_collective_s) * 1e3
    duty = 0.0 if period_ms <= 0 else (step_collective_s * 1e3) / period_ms
    return TrafficSpec(period_ms=period_ms, duty=duty, bw_gbps=bw_gbps)


def fresh_uid(prefix: str = "pod") -> str:
    return f"{prefix}-{next(_uid_counter)}"
