"""Fabric topology: host links, leaf switches, and spine uplinks.

The seed modeled contention on *host links* only (the paper's Eq. (14)
1:1-oversubscription simplification). This module generalizes the network
model to a two-tier leaf–spine fabric:

  * every node owns one **host link** (id == the node name, so that all
    node-keyed maps from the host-link-only era keep working bit-for-bit);
  * nodes are grouped into **leaves** (racks / ToR switches);
  * each leaf owns one **uplink** to the spine (id ``uplink:<leaf>``) whose
    capacity is ``sum(host bw in leaf) / oversubscription``.

Flow routing follows the seed's source-aggregated fluid model: a
multi-node job places one flow per used host link; that flow additionally
traverses the source leaf's uplink whenever the job has peers in another
leaf. Traffic entering a leaf is accounted by the remote peers' own
(symmetric) flows, which matches the all-reduce-style synchronized traffic
the paper targets.

The :meth:`Topology.star` constructor (one leaf, no uplinks) reproduces the
seed's host-link-only model exactly and is the default everywhere.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

HOST = "host"
UPLINK = "uplink"

UPLINK_PREFIX = "uplink:"


@dataclasses.dataclass
class Link:
    """One fabric link (an uplink; host links live on :class:`Node`)."""

    id: str
    capacity_gbps: float
    kind: str = UPLINK
    # the manager may lower the allocatable share (NodeBandwidth-CR analogue
    # for fabric links: reserved / unregulated cross-rack traffic)
    allocatable_gbps: Optional[float] = None

    @property
    def alloc_bw(self) -> float:
        return (self.capacity_gbps if self.allocatable_gbps is None
                else self.allocatable_gbps)

    def copy(self) -> "Link":
        return dataclasses.replace(self)


def uplink_id(leaf: str) -> str:
    return f"{UPLINK_PREFIX}{leaf}"


def is_uplink(link_id: str) -> bool:
    return link_id.startswith(UPLINK_PREFIX)


class Topology:
    """Leaf–spine fabric over a fixed node set.

    ``leaf_of`` maps node name -> leaf id; ``uplinks`` maps leaf id -> its
    :class:`Link`. A single-leaf topology has no uplinks and degenerates to
    the seed's star model.
    """

    def __init__(self, leaf_of: Mapping[str, str],
                 uplinks: Optional[Mapping[str, Link]] = None) -> None:
        self.leaf_of: Dict[str, str] = dict(leaf_of)
        self.uplinks: Dict[str, Link] = dict(uplinks or {})
        self.leaves: Dict[str, List[str]] = {}
        for node, leaf in self.leaf_of.items():
            self.leaves.setdefault(leaf, []).append(node)
        for leaf in self.uplinks:
            if leaf not in self.leaves:
                raise ValueError(f"uplink for unknown leaf {leaf!r}")

    # ------------------------------------------------------------ constructors
    @classmethod
    def star(cls, node_names: Iterable[str]) -> "Topology":
        """Seed model: all nodes on one switch, inter-switch never bottleneck."""
        return cls({n: "leaf0" for n in node_names})

    @classmethod
    def leaf_spine(
        cls,
        leaves: Mapping[str, Sequence[str]],
        *,
        host_bw_gbps: Mapping[str, float],
        oversubscription: float = 1.0,
        uplink_gbps: Optional[Mapping[str, float]] = None,
    ) -> "Topology":
        """Build a leaf–spine fabric.

        ``leaves``: leaf id -> node names. Uplink capacity per leaf is
        ``sum(host bw) / oversubscription`` unless pinned via ``uplink_gbps``.
        """
        if oversubscription <= 0:
            raise ValueError("oversubscription must be positive")
        leaf_of = {n: leaf for leaf, nodes in leaves.items() for n in nodes}
        uplinks: Dict[str, Link] = {}
        if len(leaves) > 1:
            for leaf, nodes in leaves.items():
                if uplink_gbps is not None and leaf in uplink_gbps:
                    cap = float(uplink_gbps[leaf])
                else:
                    cap = sum(host_bw_gbps[n] for n in nodes) / oversubscription
                uplinks[leaf] = Link(id=uplink_id(leaf), capacity_gbps=cap)
        return cls(leaf_of, uplinks)

    # ----------------------------------------------------------------- queries
    @property
    def is_star(self) -> bool:
        """True when no uplink can ever be traversed (seed-equivalent)."""
        return not self.uplinks

    @property
    def uplink_ids(self) -> List[str]:
        return [l.id for l in self.uplinks.values()]

    def leaf(self, node: str) -> str:
        return self.leaf_of[node]

    def uplink_of(self, node: str) -> Optional[Link]:
        return self.uplinks.get(self.leaf_of[node])

    def link(self, link_id: str) -> Optional[Link]:
        for l in self.uplinks.values():
            if l.id == link_id:
                return l
        return None

    def flow_links(self, src: str, dst_nodes: Iterable[str]) -> Tuple[str, ...]:
        """Links traversed by a flow sourced at ``src`` toward ``dst_nodes``:
        the source host link, plus the source leaf's uplink when any
        destination sits in another leaf."""
        src_leaf = self.leaf_of[src]
        up = self.uplinks.get(src_leaf)
        if up is not None and any(
                self.leaf_of[d] != src_leaf for d in dst_nodes if d != src):
            return (src, up.id)
        return (src,)

    def placement_links(self, nodes: Iterable[str]) -> List[str]:
        """All links a job placed on ``nodes`` would traverse (union over its
        per-source flows): every used host link, plus the uplink of every
        used leaf when the placement spans more than one leaf."""
        nodes = sorted(set(nodes))
        links: List[str] = list(nodes)
        leaves = {self.leaf_of[n] for n in nodes}
        if len(leaves) > 1:
            for leaf in sorted(leaves):
                up = self.uplinks.get(leaf)
                if up is not None:
                    links.append(up.id)
        return links

    def spans_leaves(self, nodes: Iterable[str]) -> bool:
        return len({self.leaf_of[n] for n in nodes}) > 1

    def copy(self) -> "Topology":
        return Topology(dict(self.leaf_of),
                        {k: v.copy() for k, v in self.uplinks.items()})
