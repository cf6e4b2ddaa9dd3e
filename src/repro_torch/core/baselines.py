"""Baseline schedulers evaluated in the paper (section IV-A).

  Default   — K8s default: resource-fit filter + least-allocated scoring.
  Diktyo    — network(latency)-aware: favors lowest aggregated network cost
              to dependent pods; modified (as in the paper) to auto-detect
              dependencies within/between jobs. No bandwidth/TDM awareness.
  Exclusive — reserves bandwidth: a node is feasible only if the sum of
              deployed bandwidth + the pod's demand fits the link capacity;
              otherwise the pod (and job, all-or-nothing) is REJECTED.
  Ideal     — each job runs on a dedicated cluster (no shared links); used
              as the contention-free reference. Implemented at the harness
              level by simulating each job alone.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .cluster import Cluster
from .framework import ScheduleContext, SchedulerPlugin, TaskRegistry
from .workload import Task


class DefaultPlugin(SchedulerPlugin):
    """K8s default scheduler approximation (NodeResourcesFit +
    LeastAllocated)."""

    name = "default"

    def filter(self, ctx, cluster: Cluster, pod: Task, node_name: str,
               registry: TaskRegistry) -> bool:
        return pod.resources.fits_in(cluster.node(node_name).free)

    def score(self, ctx, cluster: Cluster, pod: Task, node_name: str,
              registry: TaskRegistry) -> float:
        node = cluster.node(node_name)
        cap = node.capacity
        free_after = node.free - pod.resources
        terms = []
        for attr in ("cpu", "mem", "gpu"):
            c = getattr(cap, attr)
            if c > 0:
                terms.append(getattr(free_after, attr) / c)
        return 100.0 * float(np.mean(terms)) if terms else 0.0


class DiktyoPlugin(SchedulerPlugin):
    """Latency-aware scheduling (Diktyo, TNSM'23), with the paper's
    modification: same-job pods are automatically dependent."""

    name = "diktyo"

    def pre_filter(self, ctx: ScheduleContext, cluster: Cluster, pod: Task,
                   registry: TaskRegistry) -> None:
        deps = [t for t in registry.dependencies_of(pod) if t.node is not None]
        ctx.cache["deps"] = deps

    def filter(self, ctx, cluster: Cluster, pod: Task, node_name: str,
               registry: TaskRegistry) -> bool:
        return pod.resources.fits_in(cluster.node(node_name).free)

    def score(self, ctx, cluster: Cluster, pod: Task, node_name: str,
              registry: TaskRegistry) -> float:
        deps: List[Task] = ctx.cache.get("deps", [])
        if deps:
            cost = sum(cluster.tau(node_name, t.node) for t in deps)
            return float(100.0 / (1.0 + cost))
        # NOTE (paper section IV-B1): Diktyo "fails to detect the
        # dependencies of the job's first pod" — with no deployed dependency
        # it falls back to default resource (least-allocated) scoring, i.e.
        # it can land the first pod on a congested node.
        node = cluster.node(node_name)
        cap = node.capacity
        free_after = node.free - pod.resources
        terms = [
            getattr(free_after, a) / getattr(cap, a)
            for a in ("cpu", "mem", "gpu") if getattr(cap, a) > 0
        ]
        return float(np.mean(terms)) if terms else 0.0


class ExclusivePlugin(SchedulerPlugin):
    """Exclusive bandwidth reservation (refs [12],[13] in the paper)."""

    name = "exclusive"

    def filter(self, ctx, cluster: Cluster, pod: Task, node_name: str,
               registry: TaskRegistry) -> bool:
        node = cluster.node(node_name)
        if not pod.resources.fits_in(node.free):
            return False
        reserved = sum(node.pods.values())
        return reserved + pod.traffic.bw_gbps <= node.alloc_bw

    def score(self, ctx, cluster: Cluster, pod: Task, node_name: str,
              registry: TaskRegistry) -> float:
        node = cluster.node(node_name)
        reserved = sum(node.pods.values())
        return 100.0 * (1.0 - reserved / max(node.alloc_bw, 1e-9))
