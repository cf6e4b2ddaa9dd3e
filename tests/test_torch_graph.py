"""The port's minimal graph (``repro_torch.core._graph``) against networkx.

The planner's BFS offsets and the scheduler's dependency-loop check depend
on networkx's iteration orders, so the port's graph must reproduce them
exactly: component contents and order, the ``bfs_edges`` sequence, the
``cycle_basis`` cycles, and induced-subgraph edges.  Graphs are random,
seeded with numpy, with string nodes added in a shuffled order.
"""
import numpy as np
import pytest

from repro_torch.core import _graph

nx = pytest.importorskip("networkx")

SEEDS = range(12)


def _random_graphs(seed):
    """The same random undirected graph built as (networkx, port) with the
    same node and edge insertion order and shared edge payloads."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 14))
    names = [f"job-{k}" for k in rng.permutation(n)]
    g_nx, g_pt = nx.Graph(), _graph.Graph()
    for name in names:
        if rng.random() < 0.5:
            g_nx.add_node(name)
            g_pt.add_node(name)
    p = float(rng.uniform(0.05, 0.5))
    for _ in range(int(rng.integers(0, 3 * n + 1))):
        a, b = names[int(rng.integers(n))], names[int(rng.integers(n))]
        if a == b or rng.random() > p * 3:
            continue
        rel = float(rng.normal())
        if g_nx.has_edge(a, b):
            g_nx[a][b]["rels"].append(rel)
            g_pt[a][b]["rels"].append(rel)
        else:
            g_nx.add_edge(a, b, rels=[rel], src=a)
            g_pt.add_edge(a, b, rels=[rel], src=a)
    return g_nx, g_pt


@pytest.mark.parametrize("seed", SEEDS)
def test_nodes_and_adjacency_order(seed):
    g_nx, g_pt = _random_graphs(seed)
    assert list(g_pt) == list(g_nx)
    assert len(g_pt) == len(g_nx)
    for n in g_nx:
        assert list(g_pt[n]) == list(g_nx[n])
        assert list(g_pt.neighbors(n)) == list(g_nx.neighbors(n))


@pytest.mark.parametrize("seed", SEEDS)
def test_connected_components(seed):
    g_nx, g_pt = _random_graphs(seed)
    want = list(nx.connected_components(g_nx))
    got = list(_graph.connected_components(g_pt))
    assert got == want
    for n in g_nx:
        assert (_graph.node_connected_component(g_pt, n)
                == nx.node_connected_component(g_nx, n))


@pytest.mark.parametrize("seed", SEEDS)
def test_bfs_edges(seed):
    g_nx, g_pt = _random_graphs(seed)
    for source in g_nx:
        assert (list(_graph.bfs_edges(g_pt, source))
                == list(nx.bfs_edges(g_nx, source)))


@pytest.mark.parametrize("seed", SEEDS)
def test_cycle_basis(seed):
    g_nx, g_pt = _random_graphs(seed)
    assert _graph.cycle_basis(g_pt) == nx.cycle_basis(g_nx)
    for root in g_nx:
        assert _graph.cycle_basis(g_pt, root) == nx.cycle_basis(g_nx, root)


@pytest.mark.parametrize("seed", SEEDS)
def test_subgraph_edges(seed):
    g_nx, g_pt = _random_graphs(seed)
    for comp in nx.connected_components(g_nx):
        want = sorted((tuple(sorted((u, v))), tuple(d["rels"]))
                      for u, v, d in g_nx.subgraph(comp).edges(data=True))
        got = sorted((tuple(sorted((u, v))), tuple(d["rels"]))
                     for u, v, d in g_pt.subgraph(comp).edges(data=True))
        assert got == want


def test_unknown_node_raises_as_networkx_does():
    g = _graph.Graph()
    g.add_edge("a", "b")
    g_nx = nx.Graph([("a", "b")])
    with pytest.raises(nx.NetworkXError):
        list(nx.bfs_edges(g_nx, "zz"))
    with pytest.raises(_graph.NetworkXError):
        list(_graph.bfs_edges(g, "zz"))
    with pytest.raises(KeyError):
        nx.cycle_basis(g_nx, "zz")
    with pytest.raises(KeyError):
        _graph.cycle_basis(g, "zz")
