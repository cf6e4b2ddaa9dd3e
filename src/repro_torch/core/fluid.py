"""Backend-swappable fluid rate engine (progressive-filling max-min fairness).

The rate-sharing core of the event-driven simulator, refactored out of
``ClusterSimulator`` so production-scale traces (10k+ jobs) can swap the
per-flow Python loop for a batched vectorized solve:

  * ``backend='python'`` — the seed's per-flow loop, verbatim, as the
    golden oracle: per-link water filling when every path is a single host
    link (the star topology), global progressive filling otherwise.
    Bit-for-bit identical to the historical ``ClusterSimulator`` path.
  * ``backend='torch'`` — the fill expressed as a fixed point over a
    (flows x links) demand/route matrix, solved by the plain PyTorch
    version (``kernels.ref.progressive_fill_ref``), float32, on the
    engine's device.
  * ``backend='kernel'`` — same matrix form through the
    ``kernels.ops.progressive_fill`` dispatch: the hand-written CUDA fill
    kernel on a CUDA device, its plain PyTorch version on the CPU.

The vectorized backends take an explicit ``device`` (default ``"cuda"``,
which raises where no card is present).  The host side stays numpy
float64: problems are assembled as float64 blocks, and ``kernels.ops``
casts them to float32 and copies them to the device once per bucket.

The matrix form: routes[f, l] = 1 iff flow f's path crosses link l.  Each
round every unfrozen flow grows by the same increment — the minimum over
remaining per-flow headroom and remaining per-link capacity divided by the
link's active-flow count — and flows freeze when their demand is met or a
path link saturates.  This is exactly the per-flow loop's round structure,
so the vectorized backends agree with the oracle up to float32 tolerance.

Incremental recomputation rides the PR 5 epoch machinery: flows partition
into link-connected *affinity components* (two flows are connected when
their paths share a link), each component's allocation depends only on its
own demands and link capacities, and the engine memoizes per-component
solutions under a content key.  A dynamic-environment event (background
ramp, capacity change, departure) therefore re-fills only the component it
touches — the others hit the memo.  The python backend keeps incremental
mode OFF by default: the global progressive fill couples components through
the shared increment's float partial sums, so per-component solving is
equivalent mathematically but not bit-for-bit, and ``backend='python'``
must reproduce the seed exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import _device
from ..kernels import ops as kops

EPS = 1e-9

BACKENDS = ("python", "torch", "kernel")


# ---------------------------------------------------------------------------
# golden oracle: the seed's per-flow loop, verbatim
# ---------------------------------------------------------------------------

def _progressive_fill(
    demands: np.ndarray,
    paths: Sequence[Sequence[str]],
    caps: Dict[str, float],
) -> np.ndarray:
    """Progressive-filling max-min fairness over multi-link flow paths.

    All unfrozen flows grow at the same rate; a flow freezes when it reaches
    its demand or when any link on its path saturates (that link becomes its
    bottleneck). Reduces to per-link water filling when every path is a
    single link. Runs in O((flows + links) * flows).
    """
    n = len(demands)
    rates = np.zeros(n)
    if n == 0:
        return rates
    remaining = dict(caps)
    active = [i for i in range(n) if demands[i] > EPS]
    # flows on a zero-capacity link can never send
    while active:
        counts: Dict[str, int] = {}
        for i in active:
            for l in paths[i]:
                counts[l] = counts.get(l, 0) + 1
        inc = min(demands[i] - rates[i] for i in active)
        for l, c in counts.items():
            inc = min(inc, remaining[l] / c)
        inc = max(0.0, inc)
        for i in active:
            rates[i] += inc
        for l, c in counts.items():
            remaining[l] -= inc * c
        nxt = []
        for i in active:
            if rates[i] >= demands[i] - EPS:
                continue  # demand met
            if any(remaining[l] <= EPS for l in paths[i]):
                continue  # bottleneck link saturated
            nxt.append(i)
        if len(nxt) == len(active):  # pragma: no cover — defensive
            break
        active = nxt
    return rates


def _max_min_fair(demands: np.ndarray, capacity: float) -> np.ndarray:
    """Water-filling max-min fair allocation, each flow capped at its demand."""
    n = len(demands)
    if n == 0:
        return demands
    if demands.sum() <= capacity:
        return demands.copy()
    rates = np.zeros(n)
    remaining = capacity
    order = np.argsort(demands)
    left = n
    for idx in order:
        fair = remaining / left
        give = min(demands[idx], fair)
        rates[idx] = give
        remaining -= give
        left -= 1
    return rates


def fill_python(
    demands: np.ndarray,
    paths: Sequence[Tuple[str, ...]],
    caps: Dict[str, float],
) -> np.ndarray:
    """The golden-oracle solve of one fill problem (float64, per-flow loop).

    Mirrors the seed's ``_assign_rates`` dispatch exactly: all-single-link
    problems take the per-link water-filling fast path, anything else the
    global progressive fill."""
    demands = np.asarray(demands, dtype=float)
    if all(len(p) == 1 for p in paths):
        rates = np.zeros(len(demands))
        by_link: Dict[str, List[int]] = {}
        for i, p in enumerate(paths):
            by_link.setdefault(p[0], []).append(i)
        for link_id, idxs in by_link.items():
            sub = _max_min_fair(demands[idxs], caps[link_id])
            for i, r in zip(idxs, sub):
                rates[i] = float(r)
        return rates
    return _progressive_fill(demands, paths, caps)


# ---------------------------------------------------------------------------
# (flows x links) matrix form
# ---------------------------------------------------------------------------

def problem_matrix(
    demands: Sequence[float],
    paths: Sequence[Tuple[str, ...]],
    caps: Dict[str, float],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[str]]:
    """Build the (flows x links) demand/route matrix of one fill problem.

    Links are ordered by first appearance over the flows' paths, so the
    matrix is deterministic for a given flow ordering.  Returns
    ``(demands (F,), routes (F, L), cap_vec (L,), link_ids)``."""
    link_ids: List[str] = []
    index: Dict[str, int] = {}
    for p in paths:
        for l in p:
            if l not in index:
                index[l] = len(link_ids)
                link_ids.append(l)
    f, l = len(paths), len(link_ids)
    routes = np.zeros((f, max(l, 1)))
    for i, p in enumerate(paths):
        for lid in p:
            routes[i, index[lid]] = 1.0
    d = np.asarray(demands, dtype=float)
    cap_vec = np.asarray([caps[lid] for lid in link_ids] or [1.0],
                         dtype=float)
    return d, routes, cap_vec, link_ids


@dataclasses.dataclass
class CorpusStats:
    """Bucket occupancy / padding waste of batched corpus fills.

    Every :func:`fill_corpus` call with ``stats=`` accumulates how many
    (flow, link) matrix slots it actually dispatched versus how many were
    real problem content, so batching losses are visible per run instead of
    silent (ISSUE 7 satellite): ``occupancy`` near 1.0 means the buckets are
    tight; a low value means shape rounding / batch padding dominates."""

    calls: int = 0      # fill_corpus invocations
    problems: int = 0   # real problems solved (excl. batch-padding dummies)
    buckets: int = 0    # batched dispatches (fill_many calls)
    flow_used: int = 0  # real flow slots across all problems
    flow_slots: int = 0  # dispatched flow slots (B_pad x F_pad summed)
    link_used: int = 0
    link_slots: int = 0

    @property
    def flow_occupancy(self) -> float:
        return self.flow_used / self.flow_slots if self.flow_slots else 1.0

    @property
    def link_occupancy(self) -> float:
        return self.link_used / self.link_slots if self.link_slots else 1.0

    def as_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["flow_occupancy"] = self.flow_occupancy
        d["link_occupancy"] = self.link_occupancy
        return d


def _round_pow2(n: int, floor: int = 4) -> int:
    """Smallest power of two >= max(n, floor) (launch-shape bucketing)."""
    p = floor
    while p < n:
        p <<= 1
    return p


def fill_many(
    problems: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    *,
    backend: str = "torch",
    device: str = "cuda",
    pad_to: Optional[Tuple[int, int]] = None,
) -> List[np.ndarray]:
    """Solve many fill problems in ONE batched dispatch.

    ``problems``: a list of ``(demands (F_i,), routes (F_i, L_i), caps
    (L_i,))`` matrices (see :func:`problem_matrix`).  Problems are padded to
    a common (B, F_max, L_max) block — zero-demand flows never activate and
    zero-route unit-capacity links never saturate, so padding is neutral —
    and solved by the vectorized backend in a single call on ``device``.
    Returns the unpadded per-problem rate vectors.

    ``pad_to=(F, L)`` raises the pad shape beyond the batch maximum so
    repeated calls with similar problems land on a fixed set of launch
    shapes (the event-loop steady state).

    This is the production-trace throughput path: thousands of active-set
    snapshots of a 10k-job trace fill together instead of one per-flow
    Python loop each (the ``trace_corpus`` phase of ``chip_smoke.py``)."""
    if backend not in ("torch", "kernel"):
        raise ValueError(f"fill_many wants a vectorized backend, got {backend!r}")
    if not problems:
        return []
    b = len(problems)
    f_max = max(max(p[0].shape[0] for p in problems), 1)
    l_max = max(max(p[2].shape[0] for p in problems), 1)
    if pad_to is not None:
        f_max = max(f_max, int(pad_to[0]))
        l_max = max(l_max, int(pad_to[1]))
    d = np.zeros((b, f_max))
    routes = np.zeros((b, f_max, l_max))
    caps = np.ones((b, l_max))
    for i, (di, ri, ci) in enumerate(problems):
        fi, li = ri.shape
        d[i, :fi] = di
        routes[i, :fi, :li] = ri
        caps[i, :li] = ci
    if backend == "torch":
        out = kops.progressive_fill_ref(d, routes, caps, device=device)
    else:
        out = kops.progressive_fill(d, routes, caps, device=device)
    return [np.asarray(out[i, : p[0].shape[0]], dtype=float)
            for i, p in enumerate(problems)]


def fill_corpus(
    problems: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    *,
    backend: str = "torch",
    device: str = "cuda",
    chunk: int = 64,
    bucket_shapes: bool = False,
    stats: Optional[CorpusStats] = None,
) -> List[np.ndarray]:
    """Solve a large, ragged fill-problem corpus with size-bucketed batches.

    :func:`fill_many` pads every problem to the corpus-wide ``(F_max,
    L_max)``, so one 1200-flow peak snapshot makes every off-peak snapshot
    pay 1200-flow einsums.  Here problems are sorted by flow count and
    dispatched in ``chunk``-sized buckets (each padded only to its own
    maximum), which keeps the padding waste near zero on diurnal traces
    where the active set swings several-fold.  Results come back in the
    caller's order.

    ``bucket_shapes=True`` additionally rounds every bucket's (B, F, L) up
    to fixed sizes (full ``chunk`` batches, power-of-two flow/link counts)
    so a long-lived caller — the simulator's event loop re-solving dirty
    components every tick — cycles through a handful of launch shapes
    instead of a new one whenever the active set grows by one flow.
    Batch padding uses neutral dummy problems (one zero-demand flow).

    ``stats`` (a :class:`CorpusStats`) accumulates bucket occupancy /
    padding waste so the batching losses are observable per run."""
    if not problems:
        return []
    order = sorted(range(len(problems)), key=lambda i: problems[i][0].shape[0])
    out: List[Optional[np.ndarray]] = [None] * len(problems)
    chunk = max(1, int(chunk))
    if stats is not None:
        stats.calls += 1
        stats.problems += len(problems)
        stats.flow_used += sum(p[0].shape[0] for p in problems)
        stats.link_used += sum(p[2].shape[0] for p in problems)
    dummy = (np.zeros(1), np.zeros((1, 1)), np.ones(1))
    for s in range(0, len(order), chunk):
        idx = order[s:s + chunk]
        batch = [problems[i] for i in idx]
        pad_to = None
        if bucket_shapes:
            pad_to = (_round_pow2(max(p[0].shape[0] for p in batch)),
                      _round_pow2(max(p[2].shape[0] for p in batch)))
            batch = batch + [dummy] * (chunk - len(batch))
        rates = fill_many(batch, backend=backend, device=device,
                          pad_to=pad_to)
        if stats is not None:
            stats.buckets += 1
            f_pad = pad_to[0] if pad_to else max(
                max(p[0].shape[0] for p in batch), 1)
            l_pad = pad_to[1] if pad_to else max(
                max(p[2].shape[0] for p in batch), 1)
            stats.flow_slots += len(batch) * f_pad
            stats.link_slots += len(batch) * l_pad
        for i, r in zip(idx, rates):
            out[i] = r
    return out  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# affinity components (incremental re-fill)
# ---------------------------------------------------------------------------

def _first_seen_links(paths: Sequence[Tuple[str, ...]]) -> List[str]:
    """Link ids in first-appearance order over the flows' paths (the
    deterministic link ordering of memo keys and problem matrices)."""
    seen = set()
    out: List[str] = []
    for p in paths:
        for l in p:
            if l not in seen:
                seen.add(l)
                out.append(l)
    return out


def affinity_components(paths: Sequence[Tuple[str, ...]]) -> List[List[int]]:
    """Partition flows into link-connected components (union-find over the
    links their paths cross).  Components are ordered by their first flow's
    index; flows keep their relative order inside each component."""
    parent: Dict[str, str] = {}

    def find(x: str) -> str:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for p in paths:
        for l in p:
            parent.setdefault(l, l)
        for l in p[1:]:
            parent[find(p[0])] = find(l)
    comps: Dict[str, List[int]] = {}
    order: List[str] = []
    for i, p in enumerate(paths):
        root = find(p[0])
        if root not in comps:
            comps[root] = []
            order.append(root)
        comps[root].append(i)
    return [comps[r] for r in order]


@dataclasses.dataclass
class FluidStats:
    """Memo counters of one engine (incremental re-fill observability)."""

    hits: int = 0
    misses: int = 0
    solves: int = 0  # non-incremental full solves


class FluidEngine:
    """Backend-swappable progressive-filling engine.

    ``assign(flows, cap_of)`` sets ``flow.rate_gbps`` on every flow object
    (anything with ``demand_gbps`` / ``links`` / ``rate_gbps`` attributes,
    e.g. the simulator's ``FlowState``) given a per-link allocatable
    capacity function.

    ``incremental=None`` picks the backend default: OFF for ``python``
    (the global solve is the bit-for-bit seed path — see the module
    docstring) and ON for the vectorized backends, where each affinity
    component's solution is memoized under a content key of its demands,
    paths and link capacities.  An event that touches one component leaves
    every other component's key — and therefore its memoized rates —
    intact.

    ``device`` is where the vectorized backends solve (``"cuda"`` by
    default; ``"cpu"`` runs the plain PyTorch fill on the host).  Asking a
    vectorized backend for a CUDA device where none is present raises."""

    def __init__(self, backend: str = "python",
                 incremental: Optional[bool] = None,
                 memo_max: int = 4096, device: str = "cuda") -> None:
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown fluid backend {backend!r}; expected one of {BACKENDS}")
        if backend != "python":
            _device.resolve(device)
        self.backend = backend
        self.device = device
        self.incremental = (backend != "python") if incremental is None \
            else bool(incremental)
        self.memo_max = int(memo_max)
        self._memo: Dict[tuple, np.ndarray] = {}
        self.stats = FluidStats()
        self.corpus_stats = CorpusStats()
        # oracle-parity sampling (bench_dynamic_throughput): with
        # sample_stride > 0 every stride-th solve_batch problem is kept as
        # (demands, paths, caps, rates) for offline fill_python comparison
        self.sample_stride = 0
        self.sample_max = 512
        self.samples: List[tuple] = []
        self._sample_seen = 0

    # ------------------------------------------------------------- public API
    def assign(self, flows: Sequence, cap_of: Callable[[str], float]) -> None:
        if not flows:
            return
        if not self.incremental:
            self._assign_full(flows, cap_of)
            return
        for comp in affinity_components([f.links for f in flows]):
            self._assign_component([flows[i] for i in comp], cap_of)

    def fill(self, demands: np.ndarray, paths: Sequence[Tuple[str, ...]],
             caps: Dict[str, float]) -> np.ndarray:
        """Solve one fill problem with this engine's backend (no memo)."""
        if self.backend == "python":
            return fill_python(np.asarray(demands, dtype=float), paths, caps)
        d, routes, cap_vec, _ = problem_matrix(demands, paths, caps)
        return fill_many([(d, routes, cap_vec)], backend=self.backend,
                         device=self.device)[0]

    def solve_batch(self, problems: Sequence[tuple]) -> List[np.ndarray]:
        """Solve many ``(demands, paths, caps)`` problems in ONE dispatch.

        The array event loop's dirty-component path: every dirty affinity
        component of one tick arrives here together; memoized components
        (content key: demands, paths, link capacities) return instantly,
        and ALL misses go through a single shape-bucketed
        :func:`fill_corpus` batch — one kernel launch per tick instead of
        one per component.  Returns per-problem rate vectors in caller
        order.  Returned arrays are shared with the memo: treat as
        read-only."""
        out: List[Optional[np.ndarray]] = [None] * len(problems)
        keys: List[Optional[tuple]] = [None] * len(problems)
        miss: List[int] = []
        for i, (demands, paths, caps) in enumerate(problems):
            if self.incremental:
                key = (self.backend,
                       tuple((float(d), tuple(p))
                             for d, p in zip(demands, paths)),
                       tuple(caps[l] for l in _first_seen_links(paths)))
                keys[i] = key
                hit = self._memo.get(key)
                if hit is not None:
                    self.stats.hits += 1
                    out[i] = hit
                    continue
            miss.append(i)
        if miss:
            self.stats.misses += len(miss)
            if self.backend == "python":
                for i in miss:
                    d, p, c = problems[i]
                    out[i] = fill_python(np.asarray(d, dtype=float), p, c)
            else:
                mats = [problem_matrix(*problems[i])[:3] for i in miss]
                rates = fill_corpus(mats, backend=self.backend,
                                    device=self.device, bucket_shapes=True,
                                    stats=self.corpus_stats)
                for i, r in zip(miss, rates):
                    out[i] = r
            if self.incremental:
                for i in miss:
                    if len(self._memo) >= self.memo_max:
                        self._memo.clear()
                    self._memo[keys[i]] = out[i]
        if self.sample_stride > 0:
            for i, prob in enumerate(problems):
                self._sample_seen += 1
                if (self._sample_seen % self.sample_stride == 0
                        and len(self.samples) < self.sample_max):
                    self.samples.append((*prob, out[i]))
        return out  # type: ignore[return-value]

    # --------------------------------------------------------------- internals
    def _assign_full(self, flows: Sequence,
                     cap_of: Callable[[str], float]) -> None:
        """The seed's ``_assign_rates`` body, verbatim (python backend) or
        one global vectorized solve (torch/kernel with incremental off)."""
        self.stats.solves += 1
        if self.backend == "python":
            if all(len(f.links) == 1 for f in flows):
                by_link: Dict[str, List] = {}
                for f in flows:
                    by_link.setdefault(f.node, []).append(f)
                for node_name, group in by_link.items():
                    demands = np.array([f.demand_gbps for f in group])
                    rates = _max_min_fair(demands, cap_of(node_name))
                    for f, r in zip(group, rates):
                        f.rate_gbps = float(r)
                return
            caps = {l: cap_of(l) for f in flows for l in f.links}
            demands = np.array([f.demand_gbps for f in flows])
            rates = _progressive_fill(demands, [f.links for f in flows], caps)
            for f, r in zip(flows, rates):
                f.rate_gbps = float(r)
            return
        caps = {l: cap_of(l) for f in flows for l in f.links}
        rates = self.fill(np.array([f.demand_gbps for f in flows]),
                          [f.links for f in flows], caps)
        for f, r in zip(flows, rates):
            f.rate_gbps = float(r)

    def _assign_component(self, flows: Sequence,
                          cap_of: Callable[[str], float]) -> None:
        links: List[str] = []
        seen = set()
        for f in flows:
            for l in f.links:
                if l not in seen:
                    seen.add(l)
                    links.append(l)
        caps = {l: cap_of(l) for l in links}
        key = (self.backend,
               tuple((f.demand_gbps, f.links) for f in flows),
               tuple(caps[l] for l in links))
        rates = self._memo.get(key)
        if rates is None:
            self.stats.misses += 1
            if self.backend == "python":
                rates = fill_python(
                    np.array([f.demand_gbps for f in flows]),
                    [f.links for f in flows], caps)
            else:
                rates = self.fill(np.array([f.demand_gbps for f in flows]),
                                  [f.links for f in flows], caps)
            if len(self._memo) >= self.memo_max:
                self._memo.clear()
            self._memo[key] = rates
        else:
            self.stats.hits += 1
        for f, r in zip(flows, rates):
            f.rate_gbps = float(r)
