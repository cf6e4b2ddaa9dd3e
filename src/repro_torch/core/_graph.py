"""A minimal undirected graph with the few traversals the planner uses.

``rotation.resolve`` (the affinity graph and its BFS offsets) and the
scheduler's dependency-loop check need an insertion-ordered undirected
graph with per-edge attribute dicts, connected components, a BFS edge
walk and a cycle basis.  The iteration orders are part of the result: BFS
offsets accumulate float relative shifts along the tree edges, and the
loop check looks only at the cycles of one particular basis.  So every
traversal below follows the networkx 3.x algorithm step for step
(``_plain_bfs``, ``generic_bfs_edges``, Paton's ``cycle_basis``), over
adjacency dicts that keep insertion order exactly as networkx's do.
"""
from __future__ import annotations

from typing import Dict, Hashable, Iterable, Iterator, List, Set, Tuple


class NetworkXError(Exception):
    """Stand-in for ``networkx.NetworkXError`` (the loop check catches it)."""


class Graph:
    """Undirected simple graph: ``g[u][v]`` is the edge's attribute dict,
    shared by both directions; nodes and neighbours iterate in insertion
    order."""

    def __init__(self) -> None:
        self._adj: Dict[Hashable, Dict[Hashable, dict]] = {}

    def add_node(self, n: Hashable) -> None:
        if n not in self._adj:
            self._adj[n] = {}

    def add_edge(self, u: Hashable, v: Hashable, **attr) -> None:
        self.add_node(u)
        self.add_node(v)
        d = self._adj[u].get(v, {})
        d.update(attr)
        self._adj[u][v] = d
        self._adj[v][u] = d

    def has_edge(self, u: Hashable, v: Hashable) -> bool:
        return u in self._adj and v in self._adj[u]

    def neighbors(self, n: Hashable) -> Iterator[Hashable]:
        try:
            return iter(self._adj[n])
        except KeyError:
            raise NetworkXError(f"The node {n} is not in the graph.")

    def __getitem__(self, n: Hashable) -> Dict[Hashable, dict]:
        return self._adj[n]

    def __contains__(self, n: object) -> bool:
        try:
            return n in self._adj
        except TypeError:
            return False

    def __iter__(self) -> Iterator[Hashable]:
        return iter(self._adj)

    def __len__(self) -> int:
        return len(self._adj)

    def subgraph(self, nodes: Iterable[Hashable]) -> "Graph":
        """The induced subgraph on ``nodes`` (a copy sharing the edge
        attribute dicts, like networkx's view); nodes keep this graph's
        order."""
        keep = set(nodes)
        sub = Graph()
        for u, nbrs in self._adj.items():
            if u in keep:
                sub._adj[u] = {v: d for v, d in nbrs.items() if v in keep}
        return sub

    def edges(self, data: bool = False) -> List[tuple]:
        """Each undirected edge once, in networkx's adjacency order."""
        seen: Set[Hashable] = set()
        out: List[tuple] = []
        for u, nbrs in self._adj.items():
            for v, d in nbrs.items():
                if v not in seen:
                    out.append((u, v, d) if data else (u, v))
            seen.add(u)
        return out


def _plain_bfs(g: Graph, n: int, source: Hashable) -> Set[Hashable]:
    """networkx's ``connected._plain_bfs``: the node set of ``source``'s
    component."""
    adj = g._adj
    seen = {source}
    nextlevel = [source]
    while nextlevel:
        thislevel = nextlevel
        nextlevel = []
        for v in thislevel:
            for w in adj[v]:
                if w not in seen:
                    seen.add(w)
                    nextlevel.append(w)
            if len(seen) == n:
                return seen
    return seen


def connected_components(g: Graph) -> Iterator[Set[Hashable]]:
    """Component node sets, ordered by each component's first node."""
    seen: Set[Hashable] = set()
    n = len(g)
    for v in g:
        if v not in seen:
            c = _plain_bfs(g, n - len(seen), v)
            seen.update(c)
            yield c


def node_connected_component(g: Graph, n: Hashable) -> Set[Hashable]:
    return _plain_bfs(g, len(g), n)


def bfs_edges(g: Graph, source: Hashable) -> Iterator[Tuple[Hashable,
                                                           Hashable]]:
    """Tree edges of a breadth-first search from ``source``
    (networkx's ``generic_bfs_edges`` with the default neighbour order)."""
    neighbors = g.neighbors
    depth_limit = len(g)
    seen = {source}
    n = len(g)
    depth = 0
    next_parents_children = [(source, neighbors(source))]
    while next_parents_children and depth < depth_limit:
        this_parents_children = next_parents_children
        next_parents_children = []
        for parent, children in this_parents_children:
            for child in children:
                if child not in seen:
                    seen.add(child)
                    next_parents_children.append((child, neighbors(child)))
                    yield parent, child
            if len(seen) == n:
                return
        depth += 1


def cycle_basis(g: Graph, root: Hashable = None) -> List[List[Hashable]]:
    """Paton's fundamental cycle basis, as networkx computes it: one
    spanning-tree walk per component (``root``'s first), later components
    rooted at the last node not yet reached."""
    gnodes = dict.fromkeys(g)  # set-like object that maintains node order
    cycles: List[List[Hashable]] = []
    while gnodes:  # loop over connected components
        if root is None:
            root = gnodes.popitem()[0]
        stack = [root]
        pred = {root: root}
        used: Dict[Hashable, Set[Hashable]] = {root: set()}
        while stack:  # walk the spanning tree finding cycles
            z = stack.pop()  # use last-in so cycles easier to find
            zused = used[z]
            for nbr in g[z]:
                if nbr not in used:  # new node
                    pred[nbr] = z
                    stack.append(nbr)
                    used[nbr] = {z}
                elif nbr == z:  # self loops
                    cycles.append([z])
                elif nbr not in zused:  # found a cycle
                    pn = used[nbr]
                    cycle = [nbr, z]
                    p = pred[z]
                    while p not in pn:
                        cycle.append(p)
                        p = pred[p]
                    cycle.append(p)
                    cycles.append(cycle)
                    used[nbr].add(z)
        for node in pred:
            gnodes.pop(node, None)
        root = None
    return cycles
