"""The port's fluid engine (``repro_torch.core.fluid``) against the JAX
package's (``repro.core.fluid``).

  * the float64 oracle (``fill_python``, ``_progressive_fill``,
    ``_max_min_fair``) is carried over verbatim, so it must agree with the
    reference BIT FOR BIT on seeded star and leaf-spine problems;
  * the vectorized backends (``torch``, and ``kernel`` on the CPU, which
    takes the kernel's plain version) are float32 and must stay within
    1e-6 of the reference's ``fill_python`` (the bar the reference holds
    its own float32 backends to in ``bench_dynamic_throughput``);
  * affinity components, the per-component memo and the corpus statistics
    must equal the reference's.
"""
import numpy as np
import pytest

from benchmarks.bench_trace_throughput import snapshot_problem
from repro.configs.metronome_testbed import MODEL_FLEET
from repro.core import fluid as rfluid
from repro.core.trace import generate_production_trace
from repro_torch.core import fluid

ORACLE_TOL = 1e-6
SEEDS = range(30)


class _Flow:
    def __init__(self, node, demand, links):
        self.node = node
        self.demand_gbps = demand
        self.links = links
        self.rate_gbps = 0.0


def random_problem(rng, *, fabric):
    """tests/test_fluid.py's random star / 2-leaf fabric fill problem."""
    n_hosts = int(rng.integers(2, 7))
    n_flows = int(rng.integers(1, 13))
    demands = rng.uniform(0.2, 30.0, size=n_flows)
    caps = {f"h{k}": float(rng.uniform(1.0, 40.0)) for k in range(n_hosts)}
    paths = []
    for _ in range(n_flows):
        h = int(rng.integers(n_hosts))
        path = [f"h{h}"]
        if fabric and rng.random() < 0.5:
            path.append(f"uplink:{h % 2}")
        paths.append(tuple(path))
    if fabric:
        caps["uplink:0"] = float(rng.uniform(2.0, 25.0))
        caps["uplink:1"] = float(rng.uniform(2.0, 25.0))
    return demands, paths, caps


def _problems(fabric, n=len(SEEDS)):
    rng = np.random.default_rng(20261016 + fabric)
    return [random_problem(rng, fabric=fabric) for _ in range(n)]


@pytest.mark.parametrize("fabric", [False, True], ids=["star", "fabric"])
class TestOracleBitForBit:
    def test_fill_python(self, fabric):
        for d, p, c in _problems(fabric):
            want = rfluid.fill_python(np.asarray(d, dtype=float), p, c)
            got = fluid.fill_python(np.asarray(d, dtype=float), p, c)
            assert got.dtype == want.dtype
            assert np.array_equal(got, want)

    def test_progressive_fill(self, fabric):
        for d, p, c in _problems(fabric):
            assert np.array_equal(fluid._progressive_fill(d, p, c),
                                  rfluid._progressive_fill(d, p, c))

    def test_max_min_fair(self, fabric):
        rng = np.random.default_rng(7 + fabric)
        for _ in range(len(SEEDS)):
            d = rng.uniform(0.1, 30.0, size=int(rng.integers(0, 9)))
            cap = float(rng.uniform(1.0, 60.0))
            assert np.array_equal(fluid._max_min_fair(d, cap),
                                  rfluid._max_min_fair(d, cap))


def _corpus_problems():
    """16 active-set snapshots of the trace benchmark's 10,000-job
    production trace on its tiered-NIC dumbbell: the fill problems the 1e-6
    bar was set on (hundreds of flows per snapshot, so fair shares stay
    small enough for float32 to resolve 1e-6)."""
    trace = generate_production_trace(MODEL_FLEET, n_jobs=10_000, seed=7)
    horizon = max(s.submit_time_s for s in trace)
    probs = [snapshot_problem(trace, horizon * (i + 0.5) / 16)
             for i in range(16)]
    return [p for p in probs if p[0]]


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_vectorized_backends_within_1e6_of_the_reference_oracle(backend):
    probs = _corpus_problems()
    mats = [fluid.problem_matrix(d, p, c)[:3] for d, p, c in probs]
    many = fluid.fill_many(mats, backend=backend, device="cpu")
    corpus = fluid.fill_corpus(mats, backend=backend, device="cpu", chunk=4,
                               bucket_shapes=True)
    for (d, p, c), a, b in zip(probs, many, corpus):
        gold = rfluid.fill_python(np.asarray(d, dtype=float), p, c)
        np.testing.assert_allclose(a, gold, atol=ORACLE_TOL, rtol=0)
        np.testing.assert_allclose(b, gold, atol=ORACLE_TOL, rtol=0)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("fabric", [False, True], ids=["star", "fabric"])
def test_vectorized_backends_match_the_reference_jnp(backend, fabric):
    """On tests/test_fluid.py's random problems (rates up to 30 Gbps, where
    one float32 ulp is ~2e-6) the port's float32 fill tracks the
    reference's float32 jnp fill to 1e-6 relative, and the float64 oracle
    to the reference's own 5e-3."""
    probs = _problems(fabric)
    mats = [fluid.problem_matrix(d, p, c)[:3] for d, p, c in probs]
    got = fluid.fill_many(mats, backend=backend, device="cpu")
    want = rfluid.fill_many(mats, backend="jnp")
    for (d, p, c), g, w in zip(probs, got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        gold = rfluid.fill_python(np.asarray(d, dtype=float), p, c)
        np.testing.assert_allclose(g, gold, atol=5e-3, rtol=0)


def test_problem_matrix_values_match_the_reference():
    """The port builds float64 blocks and casts to float32 at the kernel
    boundary; the reference builds float32 directly: same float32 values."""
    for d, p, c in _problems(True):
        want = rfluid.problem_matrix(d, p, c)
        got = fluid.problem_matrix(d, p, c)
        assert got[3] == want[3]
        for g, w in zip(got[:3], want[:3]):
            assert np.array_equal(g.astype(np.float32), w)


def test_affinity_components_match():
    for d, p, c in _problems(True):
        assert fluid.affinity_components(p) == rfluid.affinity_components(p)


def _flows():
    return [_Flow("hA", 10.0, ("hA",)), _Flow("hA", 6.0, ("hA",)),
            _Flow("hB", 8.0, ("hB", "uplink:1")), _Flow("hB", 5.0, ("hB",))]


@pytest.mark.parametrize("backends", [("python", "python"),
                                      ("kernel", "jnp"), ("torch", "jnp")])
def test_memo_stats_and_rates_match(backends):
    mine, theirs = backends
    kw = {} if mine == "python" else {"device": "cpu"}
    eng = fluid.FluidEngine(mine, incremental=True, **kw)
    ref = rfluid.FluidEngine(theirs, incremental=True)
    caps = {"hA": 12.0, "hB": 10.0, "uplink:1": 6.0}
    for step in range(3):
        if step == 2:
            caps["uplink:1"] = 3.0  # touches only the {hB, uplink:1} part
        a, b = _flows(), _flows()
        eng.assign(a, caps.__getitem__)
        ref.assign(b, caps.__getitem__)
        assert eng.stats == ref.stats or (
            (eng.stats.hits, eng.stats.misses, eng.stats.solves)
            == (ref.stats.hits, ref.stats.misses, ref.stats.solves))
        for x, y in zip(a, b):
            assert abs(x.rate_gbps - y.rate_gbps) <= ORACLE_TOL


def test_solve_batch_corpus_stats_match():
    probs = _problems(True, n=12)
    eng = fluid.FluidEngine("kernel", device="cpu")
    ref = rfluid.FluidEngine("jnp")
    got = eng.solve_batch(probs + probs[:3])
    want = ref.solve_batch(probs + probs[:3])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ORACLE_TOL, rtol=0)
    assert eng.corpus_stats.as_dict() == ref.corpus_stats.as_dict()
    assert (eng.stats.hits, eng.stats.misses) == (ref.stats.hits,
                                                  ref.stats.misses)


def test_backend_names_and_defaults():
    assert fluid.BACKENDS == ("python", "torch", "kernel")
    assert fluid.FluidEngine("python").incremental is False
    assert fluid.FluidEngine("torch", device="cpu").incremental is True
    assert fluid.FluidEngine("kernel", device="cpu").incremental is True
    with pytest.raises(ValueError):
        fluid.FluidEngine("jnp", device="cpu")
    with pytest.raises(ValueError):
        fluid.fill_many([], backend="python")


def test_cuda_engine_refuses_to_run_on_the_host(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        fluid.FluidEngine("kernel")
    fluid.FluidEngine("python")  # the host oracle needs no device
