"""Cluster model: nodes, host links, fabric topology, latency.

Mirrors the paper's CRDs:
  - NodeBandwidth  -> :class:`Node` (capacity + deployed pods)
  - NetworkTopology-> :class:`Cluster.latency` (tau_{x,y} matrix)

The default :class:`~repro_torch.core.topology.Topology` is the paper's Eq. (14)
simplification (1:1 oversubscription): contention on *host links* only,
every node owning one host link of capacity ``bw_gbps``. Passing a
leaf–spine topology additionally models leaf->spine uplinks, which CAN be
the bottleneck on oversubscribed fabrics (see ``topology.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .topology import Topology


@dataclasses.dataclass
class Resources:
    """Multi-dimensional resource vector (paper's r_p^s, R^s(n))."""

    cpu: float = 0.0
    mem: float = 0.0  # GB
    gpu: float = 0.0  # logical GPUs (MIG slices in the testbed)

    def fits_in(self, other: "Resources") -> bool:
        return self.cpu <= other.cpu and self.mem <= other.mem and self.gpu <= other.gpu

    def __add__(self, other: "Resources") -> "Resources":
        return Resources(self.cpu + other.cpu, self.mem + other.mem, self.gpu + other.gpu)

    def __sub__(self, other: "Resources") -> "Resources":
        return Resources(self.cpu - other.cpu, self.mem - other.mem, self.gpu - other.gpu)


@dataclasses.dataclass
class Node:
    """A worker node and its host link (NodeBandwidth CR)."""

    name: str
    capacity: Resources
    bw_gbps: float  # physical host-link bandwidth capacity B_l(n)
    # NodeBandwidth CR: the manager may lower the ALLOCATABLE bandwidth to
    # account for reserved/unregulated traffic (paper section III-A); the
    # schedulers see this value, the fluid simulator uses the physical one.
    allocatable_gbps: Optional[float] = None
    # pods deployed on this node (pod uid -> bandwidth demand in Gbps)
    pods: Dict[str, float] = dataclasses.field(default_factory=dict)
    allocated: Resources = dataclasses.field(default_factory=Resources)

    @property
    def alloc_bw(self) -> float:
        return self.bw_gbps if self.allocatable_gbps is None else self.allocatable_gbps

    @property
    def free(self) -> Resources:
        return self.capacity - self.allocated

    def allocate(self, uid: str, req: Resources, bw_gbps: float) -> None:
        self.pods[uid] = bw_gbps
        self.allocated = self.allocated + req

    def release(self, uid: str, req: Resources) -> None:
        if uid in self.pods:
            del self.pods[uid]
            self.allocated = self.allocated - req


class Cluster:
    """A set of nodes plus fabric topology and the latency matrix tau."""

    def __init__(self, nodes: List[Node], latency_ms: Optional[np.ndarray] = None,
                 topology: Optional[Topology] = None):
        self.nodes: Dict[str, Node] = {n.name: n for n in nodes}
        self.node_names: List[str] = [n.name for n in nodes]
        self._index = {name: i for i, name in enumerate(self.node_names)}
        n = len(nodes)
        if latency_ms is None:
            # default: uniform 1ms between distinct nodes, 1 on the diagonal
            # (the paper defines tau_{x,x} = 1)
            latency_ms = np.ones((n, n), dtype=np.float64)
        self.latency = np.asarray(latency_ms, dtype=np.float64)
        assert self.latency.shape == (n, n)
        self.topology = topology or Topology.star(self.node_names)
        missing = set(self.node_names) - set(self.topology.leaf_of)
        if missing:
            raise ValueError(f"topology missing nodes {sorted(missing)}")
        # monotonic mutation counter (DESIGN.md section 15): every change to
        # scheduler-visible link state (allocations, allocatable/physical
        # capacities, latency) advances it so epoch-scoped planner caches
        # (repro_torch.core.rotation.PlanCache) can invalidate soundly
        self.epoch: int = 0

    def bump_epoch(self) -> None:
        """Advance the mutation epoch; callers mutating any Node/link state
        the schedulers read must invoke this (the scheduling framework and
        the simulator's event paths do)."""
        self.epoch += 1

    # -- helpers -----------------------------------------------------------
    def node(self, name: str) -> Node:
        return self.nodes[name]

    # -- unified link view --------------------------------------------------
    # Host-link ids equal node names; uplinks use ``uplink:<leaf>``. Node
    # objects stay authoritative for host-link capacities (the NodeBandwidth
    # CR path), the topology for uplinks.
    @property
    def link_ids(self) -> List[str]:
        return list(self.node_names) + self.topology.uplink_ids

    def link_capacity(self, link_id: str) -> float:
        if link_id in self.nodes:
            return self.nodes[link_id].bw_gbps
        link = self.topology.link(link_id)
        if link is None:
            raise KeyError(f"unknown link {link_id!r}")
        return link.capacity_gbps

    def link_alloc(self, link_id: str) -> float:
        """Allocatable bandwidth of a link (schedulers' Eq. 13-14 view)."""
        if link_id in self.nodes:
            return self.nodes[link_id].alloc_bw
        link = self.topology.link(link_id)
        if link is None:
            raise KeyError(f"unknown link {link_id!r}")
        return link.alloc_bw

    def index(self, name: str) -> int:
        return self._index[name]

    def tau(self, a: str, b: str) -> float:
        return float(self.latency[self._index[a], self._index[b]])

    @property
    def b_max(self) -> float:
        """B^max — maximum host-link capacity across the cluster."""
        return max(n.bw_gbps for n in self.nodes.values())

    def set_latency(self, a: str, b: str, ms: float) -> None:
        i, j = self._index[a], self._index[b]
        self.latency[i, j] = ms
        self.latency[j, i] = ms
        self.bump_epoch()

    def copy(self) -> "Cluster":
        nodes = [
            Node(
                name=n.name,
                capacity=dataclasses.replace(n.capacity),
                bw_gbps=n.bw_gbps,
                allocatable_gbps=n.allocatable_gbps,
                pods=dict(n.pods),
                allocated=dataclasses.replace(n.allocated),
            )
            for n in self.nodes.values()
        ]
        return Cluster(nodes, self.latency.copy(), self.topology.copy())


def make_testbed_cluster() -> Cluster:
    """The paper's Fig. 4 testbed: 3x A30 workers @25G + 1x T4 worker @10G.

    Each A30 is MIG-sliced into 4 logical GPUs.
    """
    nodes = [
        Node("worker-a30-0", Resources(cpu=32, mem=1024, gpu=4), bw_gbps=25.0),
        Node("worker-a30-1", Resources(cpu=32, mem=1024, gpu=4), bw_gbps=25.0),
        Node("worker-a30-2", Resources(cpu=32, mem=1024, gpu=4), bw_gbps=25.0),
        Node("worker-t4-0", Resources(cpu=20, mem=32, gpu=1), bw_gbps=10.0),
    ]
    lat = np.ones((4, 4))
    # paper introduces a congested node with a high-latency link via iPerf3;
    # benchmarks override this as needed.
    return Cluster(nodes, lat)


def make_tpu_host_cluster(n_hosts: int = 8, bw_gbps: float = 25.0,
                          chips_per_host: int = 4) -> Cluster:
    """TPU-adapted cluster: v5e hosts (4 chips each) with DCN uplinks.

    Metronome schedules training jobs onto hosts; "gpu" counts map to TPU
    chips. See DESIGN.md section 2.
    """
    nodes = [
        Node(f"host-{i}", Resources(cpu=112, mem=384, gpu=chips_per_host), bw_gbps=bw_gbps)
        for i in range(n_hosts)
    ]
    return Cluster(nodes)


def make_fabric_cluster(
    n_leaves: int = 2,
    hosts_per_leaf: int = 2,
    bw_gbps: float = 25.0,
    oversubscription: float = 2.0,
    chips_per_host: int = 4,
) -> Cluster:
    """Leaf–spine cluster: ``n_leaves`` racks of identical hosts, each rack's
    uplink carrying ``hosts_per_leaf * bw_gbps / oversubscription``.

    ``oversubscription=1.0`` makes uplinks as fat as their racks (they can
    still be shared by concurrent cross-rack jobs); the paper's star model is
    recovered with ``n_leaves=1``.
    """
    nodes = []
    leaves: Dict[str, List[str]] = {}
    for l in range(n_leaves):
        leaf = f"leaf{l}"
        leaves[leaf] = []
        for h in range(hosts_per_leaf):
            name = f"{leaf}-host{h}"
            nodes.append(Node(name, Resources(cpu=32, mem=256, gpu=chips_per_host),
                              bw_gbps=bw_gbps))
            leaves[leaf].append(name)
    topo = Topology.leaf_spine(
        leaves,
        host_bw_gbps={n.name: n.bw_gbps for n in nodes},
        oversubscription=oversubscription,
    )
    return Cluster(nodes, topology=topo)
