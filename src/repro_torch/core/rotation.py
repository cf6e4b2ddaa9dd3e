"""Fabric-wide joint rotation planner — the single producer of rotation
schemes (paper sections III-B / III-C generalized to multi-tier fabrics).

The paper's offline recalculation (Eqs. 15-18) solves rotation *per link*;
since the fabric refactor a job can traverse a host link **and** a leaf
uplink, and reconciling conflicting per-link shifts with a BFS +
"uplinks take precedence" tie-break (the pre-planner controller) can leave
a link oversubscribed in time even though each per-link solve was perfect.
This module replaces that heuristic with one global solve in the spirit of
CASSINI's affinity-graph formulation: every job receives a **single** circle
offset that is evaluated simultaneously on every link it traverses.

Layering:

  * :func:`find_feasible_rotation` / :func:`find_optimal_rotation` /
    :func:`coordinate_descent_rotation` — the per-link solvers (moved here
    from ``scoring.py``, which now only holds the per-candidate evaluators).
  * :func:`solve_link` — one link's rotation problem from a
    :class:`~repro_torch.core.contention.LinkView` (the legacy Score-phase
    ``_score_link`` generalized over demand conventions).
  * :func:`joint_solve` — the fabric-wide solve of one affinity component:
    periods unified over *all* component jobs, per-job shift ranges from
    Eq. 15 (one range per job — intersecting the per-link ranges of Eq. 15
    degenerates to the global ``S // mul_p`` once the base circle is
    shared), reference pinned per Eq. 16, Eq. 18 scored on every link at
    once (min over links), and Psi (Eq. 9) minimized over links as the
    multi-link tie-break.  Falls back to coordinate descent over jobs when
    the joint product space is too large (the paper's own reduction
    argument).
  * :func:`resolve` — global-offset resolution over a set of per-link
    schemes: consistent components keep the per-link solutions and the
    legacy BFS traversal **bit-for-bit** (star topologies always land
    here); components whose per-link solutions conflict are re-solved
    jointly.  ``joint=False`` preserves the legacy last-link-wins
    reconciliation (uplinks last in the canonical order) as an ablation.
  * :func:`plan` — the scheduler/controller entry point: per-link solve +
    conflict resolution in one call.

The joint evaluation is batched: every link's demand bank shares the
component's pattern matrix and differs only in per-job bandwidth and link
capacity, which is exactly the stacked ``(L, R, S)`` layout of the
``kernels.metronome_score`` multi-link core (``backend='kernel'``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..kernels import ops as kops
from . import _graph, geometry, scoring
from .contention import LinkView, group_demand_gbps
from .geometry import DI_PRE
from .topology import is_uplink

PERFECT = 100.0
_EPS = 1e-9
# per-link relative shifts (ms) closer than this are "the same solution"
REL_TOL_MS = 1e-6


# ---------------------------------------------------------------------------
# Epoch-scoped planner memo (DESIGN.md section 15)
# ---------------------------------------------------------------------------

class PlanCache:
    """Epoch-scoped, content-keyed memo for planner results.

    Entries live only within one ``(cluster.epoch, registry.epoch)`` epoch:
    ANY mutation of the demand view (reserve/unreserve, dynamic events,
    capacity/background changes) advances an epoch, and the first lookup
    under the new epoch clears the store wholesale — stale reuse across a
    mutation is structurally impossible.  Keys additionally capture the full
    numeric problem content (job order, demands, capacities, periods,
    priorities, solver knobs), so within an epoch the N candidate nodes of
    one Score phase share every solve whose inputs coincide.

    Views built without an epoch (``LinkView(cluster, ...)`` directly,
    ``epoch=None``) bypass the cache entirely.
    """

    def __init__(self, maxsize: int = 512) -> None:
        self.maxsize = maxsize
        self._epoch: Optional[Tuple] = None
        self._store: Dict[Tuple, Tuple] = {}
        self.hits = 0
        self.misses = 0

    def _sync(self, epoch) -> None:
        if epoch != self._epoch:
            self._store.clear()
            self._epoch = epoch

    def get(self, epoch, key):
        if epoch is None:
            return None
        self._sync(epoch)
        value = self._store.get(key)
        if value is None:
            self.misses += 1
        else:
            self.hits += 1
        return value

    def put(self, epoch, key, value) -> None:
        if epoch is None:
            return
        self._sync(epoch)
        if len(self._store) >= self.maxsize:
            self._store.clear()
        self._store[key] = value

    def clear(self) -> None:
        self._store.clear()
        self._epoch = None


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RotationResult:
    score: float
    shifts: np.ndarray  # (P,) integer slot shifts theta_{l,p}
    perfect: bool
    psi: float = 0.0  # min communication interval of the chosen scheme
    n_evaluated: int = 0


@dataclasses.dataclass
class LinkScheme:
    """Rotation scheme of one fabric link (host link id == node name,
    uplinks ``uplink:<leaf>``)."""

    jobs: List[str]  # job order used in the rotation problem
    shifts_slots: np.ndarray  # theta per job (slots)
    base_ms: float
    muls: np.ndarray
    score: float
    early_return: bool
    injected_ms: Dict[str, float]  # E_T idle injection per job
    ref_job: str = ""


@dataclasses.dataclass
class PlanResult:
    """Output of :func:`plan` / :func:`resolve`.

    ``schemes`` maps every contended link to its scheme (per-link solution
    for consistent components, the joint solution restricted to the link's
    jobs otherwise); ``offsets_ms`` is the global circle offset per job;
    ``score`` the worst per-link Eq. 18 score; ``joint_links`` which links
    were re-solved jointly (empty whenever the per-link solutions already
    agree — always on star topologies)."""

    schemes: Dict[str, LinkScheme]
    offsets_ms: Dict[str, float]
    score: float
    feasible: bool
    joint_links: List[str]
    n_evaluated: int = 0


def _copy_scheme(sch: "LinkScheme") -> "LinkScheme":
    """Defensive deep copy: cached schemes must never alias consumer-mutated
    state (the controller edits jobs/shifts/muls in place on eviction and
    offline recalculation)."""
    return LinkScheme(
        jobs=list(sch.jobs),
        shifts_slots=np.array(sch.shifts_slots, copy=True),
        base_ms=sch.base_ms,
        muls=np.array(sch.muls, copy=True),
        score=sch.score,
        early_return=sch.early_return,
        injected_ms=dict(sch.injected_ms),
        ref_job=sch.ref_job,
    )


def priority_order(registry, jobs: Sequence[str]) -> List[str]:
    """Jobs by (priority desc, deployment order asc) — Eq. 16's reference
    semantics; index 0 is the pinned reference."""
    def key(j: str):
        job = registry.jobs.get(j)
        prio = job.priority if job else 0
        sub = job.submit_time_s if job else 0.0
        return (-prio, sub, j)
    return sorted(jobs, key=key)


# ---------------------------------------------------------------------------
# Chunked lexicographic scan (shared by the per-link and joint solvers)
# ---------------------------------------------------------------------------

def _perfect_runs(perfect: np.ndarray) -> List[Tuple[int, int]]:
    """[(start, end)] of every maximal run of True, vectorized."""
    idx = np.flatnonzero(perfect)
    if idx.size == 0:
        return []
    brk = np.flatnonzero(np.diff(idx) != 1)
    starts = np.concatenate(([idx[0]], idx[brk + 1]))
    ends = np.concatenate((idx[brk], [idx[-1]]))
    return list(zip(starts.tolist(), ends.tolist()))


class _RunScan:
    """Incremental perfect-run scanner over consecutive score chunks.

    Replicates the historical per-combo traversal semantics exactly:

      * ``mode='fast'`` — finish at the END of the FIRST maximal perfect
        run, returning its middle index (or its start under the
        ``rotation_mode='compact'`` no-cushion ablation);
      * ``mode='optimal'`` — collect every maximal run's midpoint as a Psi
        candidate, then maximize Psi among them (the 3rd stage);
      * no perfect combo — the first strict argmax over all scores wins.

    Chunk boundaries are invisible to the result: runs spanning chunks are
    stitched, so any chunking (including the one-shot batched kernel path)
    yields identical shifts.  ``eval_scale`` multiplies the per-chunk combo
    count into ``n_evaluated`` (the joint solver counts combos x links).
    """

    def __init__(self, ranges: Sequence[int], n_total: int, *, mode: str,
                 rotation_mode: str,
                 psi_of: Callable[[np.ndarray], float],
                 eval_scale: int = 1) -> None:
        self.ranges = list(ranges)
        self.n_total = n_total
        self.mode = mode
        self.rotation_mode = rotation_mode
        self.psi_of = psi_of
        self.eval_scale = eval_scale
        self.candidates: List[int] = []
        self.best_score = -1.0
        self.best_idx = 0
        self.n_eval = 0
        self.result: Optional[RotationResult] = None
        self._run_start: Optional[int] = None

    def _close(self, start: int, end: int) -> bool:
        """A maximal perfect run [start, end] completed (global indices)."""
        if self.mode == "fast":
            mid = (start if self.rotation_mode == "compact"
                   else (start + end) // 2)
            shifts = scoring.lex_combos(self.ranges, mid, 1)[0]
            self.result = RotationResult(PERFECT, shifts, True,
                                         self.psi_of(shifts), self.n_eval)
            return True
        self.candidates.append((start + end) // 2)
        return False

    def feed(self, pos: int, scores: np.ndarray) -> bool:
        """Consume the chunk starting at global index ``pos``; True once the
        scan is resolved (fast mode found its run)."""
        if self.result is not None:
            return True
        cnt = len(scores)
        self.n_eval += cnt * self.eval_scale
        perfect = scores >= PERFECT - _EPS
        runs = _perfect_runs(perfect)
        if self._run_start is not None:
            if runs and runs[0][0] == 0:
                start0, end0 = runs.pop(0)
                if end0 == cnt - 1 and pos + cnt < self.n_total:
                    pass  # run still open into the next chunk
                else:
                    if self._close(self._run_start, pos + end0):
                        return True
                    self._run_start = None
            else:
                if self._close(self._run_start, pos - 1):
                    return True
                self._run_start = None
        for start, end in runs:
            if end == cnt - 1 and pos + cnt < self.n_total:
                self._run_start = pos + start  # continues into the next chunk
            else:
                if self._close(pos + start, pos + end):
                    return True
        imperfect = ~perfect
        if imperfect.any():
            local = int(np.argmax(np.where(imperfect, scores, -np.inf)))
            if scores[local] > self.best_score:
                self.best_score = float(scores[local])
                self.best_idx = pos + local
        return False

    def finish(self, n_eval: Optional[int] = None) -> RotationResult:
        """Resolve after the last chunk; ``n_eval`` overrides the combo
        count (find_optimal_rotation historically reported n_total)."""
        if self.result is not None:
            return self.result
        if self._run_start is not None:
            if self._close(self._run_start, self.n_total - 1):
                return self.result
            self._run_start = None
        reported = self.n_eval if n_eval is None else n_eval
        if self.mode == "optimal" and self.candidates:
            best_psi = -1.0
            best_shifts = None
            for c in self.candidates:
                shifts = scoring.lex_combos(self.ranges, c, 1)[0]
                psi = self.psi_of(shifts)
                if psi > best_psi:
                    best_psi = psi
                    best_shifts = shifts
            self.result = RotationResult(PERFECT, best_shifts, True, best_psi,
                                         reported)
            return self.result
        shifts = scoring.lex_combos(self.ranges, self.best_idx, 1)[0]
        self.result = RotationResult(self.best_score, shifts, False,
                                     self.psi_of(shifts), reported)
        return self.result


def _lex_spans(ranges: Sequence[int], chunk: int):
    """Yield (global_pos, major_start, major_count, span_size) covering the
    whole combo space in lexicographic order, aligned on the most
    significant free digit (the :func:`scoring.lex_block_scores` layout), or
    None when the minor product is too large to materialize (fall back to
    the gather-based path)."""
    free = [i for i, r in enumerate(ranges) if r > 1]
    minor = scoring.minor_product(ranges)
    if not free or minor > max(int(chunk), 1):
        return None
    major_r = ranges[free[0]]
    step = max(1, int(chunk) // minor)
    spans = []
    a = 0
    while a < major_r:
        cnt = min(step, major_r - a)
        spans.append((a * minor, a, cnt, cnt * minor))
        a += cnt
    return spans


def _score_chunks(patterns: np.ndarray, bw_rows: np.ndarray,
                  caps: np.ndarray, ranges: Sequence[int], bank,
                  chunk: int):
    """Generator of (pos, (M, K) scores) chunks over the full lex space.

    Uses the broadcast block evaluator (no per-combo gathers) whenever the
    minor product fits the chunk budget; otherwise decodes combos and calls
    :func:`scoring.score_combos` per row — both bit-identical to the
    historical row-by-row scoring."""
    bw_rows = np.asarray(bw_rows, dtype=np.float64)
    caps = np.asarray(caps, dtype=np.float64).reshape(-1)
    n_total = scoring.total_combos(ranges)
    spans = _lex_spans(ranges, chunk)
    if spans is not None:
        for pos, a, cnt, _size in spans:
            yield pos, scoring.lex_block_scores(patterns, bw_rows, caps,
                                                ranges, bank, a, cnt)
        return
    pos = 0
    while pos < n_total:
        cnt = min(int(chunk), n_total - pos)
        combos = scoring.lex_combos(ranges, pos, cnt)
        out = np.empty((bw_rows.shape[0], cnt), dtype=np.float64)
        for m in range(bw_rows.shape[0]):
            out[m] = scoring.score_combos(patterns, bw_rows[m],
                                          float(caps[m]), combos, bank)
        yield pos, out
        pos += cnt


# ---------------------------------------------------------------------------
# Per-link solvers (section III-B / III-C, single link)
# ---------------------------------------------------------------------------

def find_feasible_rotation(
    patterns: np.ndarray,
    bw: Sequence[float],
    capacity: float,
    muls: Sequence[int],
    ref_index: int = 0,
    n_slots: int = DI_PRE,
    chunk: int = 8192,
    max_exhaustive: int = 1 << 22,
    mode: str = "intermediate",
) -> RotationResult:
    """Score-phase fast path (Algorithm 1, Score extension point).

    Traverses combos lexicographically and stops at the first maximal run of
    perfect scores, returning the scheme at the run's middle index. Falls
    back to the best seen score when no perfect combo exists.

    ``mode='compact'`` is the paper's 3rd-stage ABLATION (section IV-C):
    take the first index of the perfect run (comm phases packed
    back-to-back, no cushion slots) instead of the middle.
    """
    bw = np.asarray(bw, dtype=np.float64)
    ranges = scoring.shift_ranges(muls, ref_index, n_slots)
    n_total = scoring.total_combos(ranges)
    if n_total > max_exhaustive:
        return coordinate_descent_rotation(
            patterns, bw, capacity, muls, ref_index, n_slots
        )
    bank = scoring.rolled_bank(patterns, ranges)

    def psi_of(shifts: np.ndarray) -> float:
        return scoring.scheme_psi(patterns, bw, capacity, muls, shifts,
                                  n_slots)

    scan = _RunScan(ranges, n_total, mode="fast", rotation_mode=mode,
                    psi_of=psi_of)
    for pos, scores in _score_chunks(patterns, bw[None, :],
                                     np.array([capacity]), ranges, bank,
                                     chunk):
        if scan.feed(pos, scores[0]):
            break
    return scan.finish()


def find_optimal_rotation(
    patterns: np.ndarray,
    bw: Sequence[float],
    capacity: float,
    muls: Sequence[int],
    ref_index: int = 0,
    n_slots: int = DI_PRE,
    chunk: int = 8192,
    max_exhaustive: int = 1 << 22,
    scorer: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> RotationResult:
    """Offline recalculation (3rd optimization stage), section III-C.

    Enumerates all rotation schemes; candidate set = middle indices of all
    perfect-score runs (the paper's search-space narrowing); among candidates
    maximizes Psi (Eq. 9). ``scorer`` may override the combo scorer (used to
    plug in the score kernel).
    """
    bw = np.asarray(bw, dtype=np.float64)
    ranges = scoring.shift_ranges(muls, ref_index, n_slots)
    n_total = scoring.total_combos(ranges)
    if n_total > max_exhaustive:
        return coordinate_descent_rotation(
            patterns, bw, capacity, muls, ref_index, n_slots, optimize_psi=True
        )
    bank = scoring.rolled_bank(patterns, ranges)

    def psi_of(shifts: np.ndarray) -> float:
        return scoring.scheme_psi(patterns, bw, capacity, muls, shifts,
                                  n_slots)

    scan = _RunScan(ranges, n_total, mode="optimal",
                    rotation_mode="intermediate", psi_of=psi_of)
    if scorer is not None:
        pos = 0
        while pos < n_total:
            cnt = min(chunk, n_total - pos)
            combos = scoring.lex_combos(ranges, pos, cnt)
            scan.feed(pos, np.asarray(scorer(combos)))
            pos += cnt
    else:
        for pos, scores in _score_chunks(patterns, bw[None, :],
                                         np.array([capacity]), ranges, bank,
                                         chunk):
            scan.feed(pos, scores[0])
    return scan.finish(n_eval=n_total)


def coordinate_descent_rotation(
    patterns: np.ndarray,
    bw: np.ndarray,
    capacity: float,
    muls: Sequence[int],
    ref_index: int,
    n_slots: int = DI_PRE,
    optimize_psi: bool = False,
    sweeps: int = 4,
) -> RotationResult:
    """Large combo spaces: hold all but one pod fixed (paper's reduction)."""
    bw = np.asarray(bw, dtype=np.float64)
    p = patterns.shape[0]
    ranges = scoring.shift_ranges(muls, ref_index, n_slots)
    shifts = np.zeros(p, dtype=np.int64)
    n_eval = 0
    for _ in range(sweeps):
        changed = False
        for i in range(p):
            if i == ref_index or ranges[i] <= 1:
                continue
            cands = np.tile(shifts, (ranges[i], 1))
            cands[:, i] = np.arange(ranges[i])
            scores = scoring.score_combos(patterns, bw, capacity, cands)
            n_eval += ranges[i]
            best = scores.max()
            mask = scores >= best - _EPS
            if optimize_psi and best >= PERFECT - _EPS:
                # pick the perfect shift maximizing Psi
                idxs = np.nonzero(mask)[0]
                psis = [
                    scoring.scheme_psi(patterns, bw, capacity, muls, cands[k],
                                       n_slots)
                    for k in idxs
                ]
                pick = int(idxs[int(np.argmax(psis))])
            else:
                # middle of the first perfect/best run
                idxs = np.nonzero(mask)[0]
                runs = np.split(idxs, np.where(np.diff(idxs) != 1)[0] + 1)
                pick = int(runs[0][len(runs[0]) // 2])
            if pick != shifts[i]:
                shifts[i] = pick
                changed = True
        if not changed:
            break
    final = scoring.score_combos(patterns, bw, capacity, shifts[None, :])[0]
    return RotationResult(
        float(final), shifts, final >= PERFECT - _EPS,
        scoring.scheme_psi(patterns, bw, capacity, muls, shifts, n_slots),
        n_eval)


# ---------------------------------------------------------------------------
# One link's rotation problem from the LinkView
# ---------------------------------------------------------------------------

def _link_demands(view: LinkView, link_id: str, jobs: Sequence[str],
                  demand: str) -> List[float]:
    """Per-job demand on one link under the named convention.

    ``'planning'`` — the Score-phase view (the link's grouped tasks);
    ``'recalc'``  — the controller's offline-recalculation view (whole-job
    demand on host links; see :meth:`LinkView.recalc_demands`)."""
    if demand == "recalc":
        return view.recalc_demands(link_id, jobs)
    groups = view.link_groups(link_id)
    return [group_demand_gbps(groups.get(j, [])) for j in jobs]


def solve_link(
    view: LinkView,
    registry,
    link_id: str,
    *,
    self_job: Optional[str] = None,
    mode: str = "fast",
    demand: str = "planning",
    di_pre: int = DI_PRE,
    g_t_ms: float = 5.0,
    e_t_frac: float = 0.10,
    rotation_mode: str = "intermediate",
    cache: Optional[PlanCache] = None,
) -> Tuple[float, Optional[LinkScheme]]:
    """One link's rotation problem. Returns (score, scheme); scheme is None
    on the early-return paths (empty link, only the candidate's own job, or
    aggregate demand within capacity — no contention to solve).

    With a ``cache`` the solve is memoized on the full numeric content of
    the problem (scoped to the view's epoch): the Score phase solves each
    DISTINCT link problem once even when N candidate nodes share it, and a
    link whose groups are untouched by the candidate delta is never
    re-solved per candidate."""
    groups = view.link_groups(link_id)
    cap = view.cluster.link_alloc(link_id)
    total_bw = sum(group_demand_gbps(ts) for ts in groups.values())
    only_self = self_job is not None and list(groups.keys()) == [self_job]
    if not groups or only_self or total_bw <= cap:
        return PERFECT, None

    # --- two-dimensional bandwidth scheduling: interleave phases -----------
    jobs = priority_order(registry, groups.keys())
    ref_index = 0  # highest priority (ties: earliest) — Eq. 16
    periods = []
    comms = []
    prios = []
    for j in jobs:
        spec = groups[j][0].traffic
        periods.append(spec.period_ms)
        comms.append(spec.comm_ms)
        job = registry.jobs.get(j)
        prios.append(job.priority if job else 0)
    bws = _link_demands(view, link_id, jobs, demand)
    key = None
    if cache is not None:
        # the content below fully determines the solve (unification,
        # duties, patterns and ranges all derive from it); self_job and
        # link_id deliberately excluded — past the early returns they do
        # not influence the result, so identical problems share
        key = ("link", tuple(jobs), tuple(periods), tuple(comms),
               tuple(prios), tuple(bws), cap, mode, demand, rotation_mode,
               di_pre, g_t_ms, e_t_frac)
        hit = cache.get(view.epoch, key)
        if hit is not None:
            score, scheme = hit
            return score, _copy_scheme(scheme)
    unified = geometry.unify_periods(
        periods, prios, g_t_ms=g_t_ms, e_t_frac=e_t_frac
    )
    duties = []
    for idx, j in enumerate(jobs):
        # idle injection stretches the period -> duty shrinks (comm time
        # m_p is unchanged); this is the E_T mechanism's second insight.
        duties.append(min(1.0, comms[idx] / unified.periods_ms[idx]))
    patterns = geometry.pattern_matrix(unified.muls, duties, di_pre)
    if mode == "optimal":
        result = find_optimal_rotation(patterns, bws, cap, unified.muls,
                                       ref_index, di_pre)
    else:
        result = find_feasible_rotation(patterns, bws, cap, unified.muls,
                                        ref_index, di_pre,
                                        mode=rotation_mode)
    scheme = LinkScheme(
        jobs=jobs,
        shifts_slots=result.shifts,
        base_ms=unified.base_ms,
        muls=unified.muls,
        score=float(result.score),
        early_return=False,
        injected_ms={j: float(unified.injected_ms[i])
                     for i, j in enumerate(jobs)},
        ref_job=jobs[ref_index],
    )
    if cache is not None:
        cache.put(view.epoch, key, (float(result.score),
                                    _copy_scheme(scheme)))
    return float(result.score), scheme


@dataclasses.dataclass
class _LinkProblem:
    """One past-the-early-returns per-link solve (solve_link's core)."""

    jobs: List[str]
    bws: np.ndarray
    cap: float
    unified: object  # geometry.UnifiedPeriods
    comms: List[float]
    patterns: np.ndarray
    ranges: Tuple[int, ...]


def _link_scheme_of(prob: _LinkProblem, result: RotationResult,
                    ref_index: int = 0) -> Tuple[float, LinkScheme]:
    """solve_link's epilogue: wrap a RotationResult as a LinkScheme."""
    scheme = LinkScheme(
        jobs=prob.jobs,
        shifts_slots=result.shifts,
        base_ms=prob.unified.base_ms,
        muls=prob.unified.muls,
        score=float(result.score),
        early_return=False,
        injected_ms={j: float(prob.unified.injected_ms[i])
                     for i, j in enumerate(prob.jobs)},
        ref_job=prob.jobs[ref_index],
    )
    return float(result.score), scheme


def solve_link_batch(
    specs: Sequence[Tuple[LinkView, str]],
    registry,
    *,
    self_job: Optional[str] = None,
    mode: str = "fast",
    demand: str = "planning",
    di_pre: int = DI_PRE,
    g_t_ms: float = 5.0,
    e_t_frac: float = 0.10,
    rotation_mode: str = "intermediate",
    max_exhaustive: int = 1 << 22,
    chunk: int = 8192,
    cache: Optional[PlanCache] = None,
) -> List[Tuple[float, Optional[LinkScheme]]]:
    """Solve MANY per-link rotation problems (one per ``(view, link_id)``
    spec) with one shared enumeration pass per problem family.

    The Score phase raises one per-link solve for every link of every
    surviving candidate; candidates share the link's job set away from the
    candidate delta, so most problems repeat the same ``(patterns,
    ranges)`` and differ only in the demand row.  Mirroring
    :func:`joint_solve_batch`: cache hits and content-key duplicates are
    filtered first, the remainder group into families, and each family
    scores every chunk of its combo space for all members in one stacked
    :func:`_score_chunks` evaluation — each member's run scan consumes its
    own row, which is bit-for-bit the result :func:`solve_link` would
    produce for it individually.  Singleton families, ``mode='optimal'``
    and past-``max_exhaustive`` spaces take the historical per-problem
    path.  Results land in ``cache`` (when given), so the per-candidate
    ``plan()`` pass that follows hits instead of re-solving."""
    n = len(specs)
    results: List[Optional[Tuple[float, Optional[LinkScheme]]]] = [None] * n
    probs: List[Optional[_LinkProblem]] = [None] * n
    keys: List[Optional[Tuple]] = [None] * n
    epochs = [view.epoch for view, _ in specs]
    seen_keys: Dict[Tuple, int] = {}
    todo: Dict[Tuple, List[int]] = {}

    for i, (view, link_id) in enumerate(specs):
        groups = view.link_groups(link_id)
        cap = view.cluster.link_alloc(link_id)
        total_bw = sum(group_demand_gbps(ts) for ts in groups.values())
        only_self = (self_job is not None
                     and list(groups.keys()) == [self_job])
        if not groups or only_self or total_bw <= cap:
            results[i] = (PERFECT, None)
            continue
        jobs = priority_order(registry, groups.keys())
        periods, comms, prios = [], [], []
        for j in jobs:
            spec = groups[j][0].traffic
            periods.append(spec.period_ms)
            comms.append(spec.comm_ms)
            job = registry.jobs.get(j)
            prios.append(job.priority if job else 0)
        bws = _link_demands(view, link_id, jobs, demand)
        key = ("link", tuple(jobs), tuple(periods), tuple(comms),
               tuple(prios), tuple(bws), cap, mode, demand, rotation_mode,
               di_pre, g_t_ms, e_t_frac)
        keys[i] = key
        if cache is not None:
            hit = cache.get(epochs[i], key)
            if hit is not None:
                score, scheme = hit
                results[i] = (score, _copy_scheme(scheme))
                continue
        if key in seen_keys:
            continue  # duplicate: filled from the first solve below
        seen_keys[key] = i
        unified = geometry.unify_periods(periods, prios, g_t_ms=g_t_ms,
                                         e_t_frac=e_t_frac)
        duties = [min(1.0, comms[idx] / unified.periods_ms[idx])
                  for idx in range(len(jobs))]
        patterns = geometry.pattern_matrix(unified.muls, duties, di_pre)
        ranges = tuple(scoring.shift_ranges(unified.muls, 0, di_pre))
        probs[i] = _LinkProblem(jobs=jobs, bws=np.asarray(bws, np.float64),
                                cap=float(cap), unified=unified, comms=comms,
                                patterns=patterns, ranges=ranges)
        n_total = scoring.total_combos(ranges)
        fam = (patterns.tobytes(), ranges, n_total)
        todo.setdefault(fam, []).append(i)

    for fam, members in todo.items():
        group = [probs[i] for i in members]
        n_total = fam[2]
        if (len(group) == 1 or mode == "optimal"
                or n_total > max_exhaustive):
            for i in members:
                p = probs[i]
                if mode == "optimal":
                    result = find_optimal_rotation(
                        p.patterns, p.bws, p.cap, p.unified.muls, 0, di_pre)
                else:
                    result = find_feasible_rotation(
                        p.patterns, p.bws, p.cap, p.unified.muls, 0, di_pre,
                        chunk=chunk, max_exhaustive=max_exhaustive,
                        mode=rotation_mode)
                results[i] = _link_scheme_of(p, result)
            continue
        base = group[0]
        bank = scoring.rolled_bank(base.patterns, base.ranges)
        scans = []
        for p in group:
            def psi_of(shifts, _p=p):
                return scoring.scheme_psi(_p.patterns, _p.bws, _p.cap,
                                          _p.unified.muls, shifts, di_pre)
            scans.append(_RunScan(base.ranges, n_total, mode="fast",
                                  rotation_mode=rotation_mode,
                                  psi_of=psi_of))
        bw_rows = np.stack([p.bws for p in group])
        caps = np.asarray([p.cap for p in group], dtype=np.float64)
        # per-chunk combo budget shrinks with the stacked row count (the
        # scan is chunk-invariant); the minor-product floor keeps the
        # gather-free block path usable
        fam_chunk = max(scoring.minor_product(base.ranges),
                        int(chunk) // len(group))
        pending = set(range(len(group)))
        for pos, block in _score_chunks(base.patterns, bw_rows, caps,
                                        base.ranges, bank, fam_chunk):
            for pi in sorted(pending):
                if scans[pi].feed(pos, block[pi]):
                    pending.discard(pi)
            if not pending:
                break
        for i, p, scan in zip(members, group, scans):
            results[i] = _link_scheme_of(p, scan.finish())

    # propagate duplicates and fill the cache
    for i in range(n):
        if results[i] is not None or keys[i] is None:
            continue
        src = seen_keys.get(keys[i])
        if src is not None and results[src] is not None:
            score, scheme = results[src]
            results[i] = (score, _copy_scheme(scheme))
    if cache is not None:
        for i in range(n):
            if keys[i] is not None and results[i] is not None:
                score, scheme = results[i]
                if scheme is not None:
                    cache.put(epochs[i], keys[i],
                              (score, _copy_scheme(scheme)))
    return [r if r is not None else (PERFECT, None) for r in results]


def replan_link(view: LinkView, link_id: str, scheme: LinkScheme,
                capacity: float, di_pre: int = DI_PRE) -> RotationResult:
    """Offline 3rd-stage re-solve of one EXISTING scheme (the controller's
    pending-recalc path): keep the scheme's job order / unified base, re-read
    demand from the live view under the recalc convention, maximize Psi."""
    duties, bws = view.recalc_traffic(link_id, scheme.jobs, scheme.muls,
                                      scheme.base_ms)
    patterns = geometry.pattern_matrix(scheme.muls, duties, di_pre)
    ref_index = (scheme.jobs.index(scheme.ref_job)
                 if scheme.ref_job in scheme.jobs else 0)
    return find_optimal_rotation(patterns, bws, capacity, scheme.muls,
                                 ref_index, di_pre)


# ---------------------------------------------------------------------------
# Joint multi-link solve (one affinity component)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class JointResult:
    jobs: List[str]
    shifts: np.ndarray  # (P,) global slot shifts
    base_ms: float
    muls: np.ndarray
    schemes: Dict[str, LinkScheme]  # per link, restricted to its jobs
    offsets_ms: Dict[str, float]
    score: float  # min over links
    psi: float  # min over links (Eq. 9)
    feasible: bool
    n_evaluated: int = 0


def _min_link_scores(patterns: np.ndarray, bw_lp: np.ndarray,
                     caps: np.ndarray, combos: np.ndarray,
                     banks) -> np.ndarray:
    """(K,) joint score: Eq. 18 evaluated on every link, min over links."""
    out = None
    for li in range(len(caps)):
        s = scoring.score_combos(patterns, bw_lp[li], float(caps[li]),
                                 combos, banks)
        out = s if out is None else np.minimum(out, s)
    return out


def _kernel_joint_scores(patterns: np.ndarray, bw_lp: np.ndarray,
                         caps: np.ndarray, ranges: Sequence[int],
                         banks, device: str) -> Optional[np.ndarray]:
    """Batched multi-link evaluation of the FULL combo space via the
    stacked (L, R, S) kernel on ``device``; None when the space has != 2
    free jobs (the pairwise product layout does not apply)."""
    free = [i for i, r in enumerate(ranges) if r > 1]
    if len(free) != 2:
        return None
    pa, pb = free
    l, p = bw_lp.shape
    s = patterns.shape[1]
    base = np.zeros((l, s))
    for i in range(p):
        if i not in (pa, pb):
            base += bw_lp[:, i:i + 1] * patterns[i][None, :]
    bank_a = bw_lp[:, pa, None, None] * banks[pa][None, :, :]  # (L, Ra, S)
    bank_b = bw_lp[:, pb, None, None] * banks[pb][None, :, :]  # (L, Rb, S)
    scores = kops.score_multilink(base, bank_a, bank_b, np.asarray(caps),
                                  device=device)
    # C-order flatten == lexicographic combo order (free job a is the more
    # significant digit; every other range is 1)
    return np.asarray(scores).reshape(-1)


@dataclasses.dataclass
class JointProblem:
    """One affinity component's joint rotation problem, fully materialized
    (the numeric content is the memo key; the solve is a pure function of
    it)."""

    links: List[str]
    jobs: List[str]
    unified: geometry.UnifiedPeriods
    patterns: np.ndarray
    ranges: List[int]
    caps: np.ndarray  # (L,)
    bw_lp: np.ndarray  # (L, P)
    on_link: Dict[str, List[int]]  # link -> job indices present there
    key: Tuple  # content key (includes every solver knob)


def _build_joint_problem(
    view: LinkView,
    registry,
    links: Sequence[str],
    jobs: Optional[Sequence[str]],
    *,
    mode: str,
    demand: str,
    rotation_mode: str,
    di_pre: int,
    g_t_ms: float,
    e_t_frac: float,
    backend: str,
    max_exhaustive: int,
    device: str,
) -> Optional[JointProblem]:
    """The joint_solve prologue: groups, job order, unified periods, demand
    banks.  None when a job has no tasks in the view (stale scheme).

    The content key captures EVERY input that can change the solve's
    output, including the solver-selection knobs (``max_exhaustive`` picks
    exhaustive-vs-coordinate-descent, which produce different shifts; the
    ``kernel`` backend's ``device`` picks the CUDA kernel or its plain
    version, whose float32 sums may round differently)."""
    groups_by_link = {l: view.link_groups(l) for l in links}
    if jobs is None:
        seen: Dict[str, None] = {}
        for l in links:
            for j in groups_by_link[l]:
                seen[j] = None
        jobs = list(seen)
    jobs = priority_order(registry, jobs)
    if not jobs:
        return None
    specs = []
    for j in jobs:
        ts = view.job_tasks(j)
        if not ts:
            return None
        specs.append(ts[0].traffic)
    prios = []
    for j in jobs:
        job = registry.jobs.get(j)
        prios.append(job.priority if job else 0)
    unified = geometry.unify_periods([s.period_ms for s in specs], prios,
                                     g_t_ms=g_t_ms, e_t_frac=e_t_frac)
    duties = [min(1.0, specs[i].comm_ms / unified.periods_ms[i])
              for i in range(len(jobs))]
    patterns = geometry.pattern_matrix(unified.muls, duties, di_pre)
    ranges = scoring.shift_ranges(unified.muls, 0, di_pre)
    caps = np.array([view.cluster.link_alloc(l) for l in links])
    bw_lp = np.zeros((len(links), len(jobs)))
    on_link: Dict[str, List[int]] = {}
    for li, l in enumerate(links):
        dmds = _link_demands(view, l, jobs, demand)
        present = groups_by_link[l]
        on_link[l] = [pi for pi, j in enumerate(jobs) if j in present]
        for pi, j in enumerate(jobs):
            bw_lp[li, pi] = dmds[pi] if j in present else 0.0
    key = ("joint", tuple(links), tuple(jobs), bw_lp.tobytes(),
           caps.tobytes(),
           tuple((s.period_ms, s.comm_ms) for s in specs), tuple(prios),
           tuple(tuple(on_link[l]) for l in links),
           mode, demand, rotation_mode, di_pre, g_t_ms, e_t_frac, backend,
           max_exhaustive, device if backend == "kernel" else None)
    return JointProblem(links=list(links), jobs=list(jobs), unified=unified,
                        patterns=patterns, ranges=ranges, caps=caps,
                        bw_lp=bw_lp, on_link=on_link, key=key)


def _joint_psi_of(prob: JointProblem, di_pre: int):
    def psi_of(shifts: np.ndarray) -> float:
        return min(
            scoring.scheme_psi(prob.patterns, prob.bw_lp[li],
                               float(prob.caps[li]), prob.unified.muls,
                               shifts, di_pre)
            for li in range(len(prob.links))
        )
    return psi_of


def _finish_joint(prob: JointProblem, result: RotationResult,
                  di_pre: int) -> JointResult:
    """Assemble the per-link schemes / global offsets from the chosen joint
    shifts (the joint_solve epilogue, shared with the batched path)."""
    shifts = result.shifts
    unified = prob.unified
    jobs = prob.jobs
    delays = geometry.shifts_to_delay_ms(shifts, unified.base_ms, di_pre)
    offsets = {j: float(d) for j, d in zip(jobs, delays)}
    schemes: Dict[str, LinkScheme] = {}
    link_scores: List[float] = []
    for li, l in enumerate(prob.links):
        on_link = prob.on_link[l]
        sc = float(scoring.score_combos(
            prob.patterns, prob.bw_lp[li], float(prob.caps[li]),
            shifts[None, :])[0])
        link_scores.append(sc)
        link_jobs = [jobs[pi] for pi in on_link]
        ref = link_jobs[0] if link_jobs else ""
        schemes[l] = LinkScheme(
            jobs=link_jobs,
            shifts_slots=shifts[on_link].copy(),
            base_ms=float(unified.base_ms),
            muls=unified.muls[on_link].copy(),
            score=sc,
            early_return=False,
            injected_ms={jobs[pi]: float(unified.injected_ms[pi])
                         for pi in on_link},
            ref_job=ref,
        )
    worst = min(link_scores) if link_scores else PERFECT
    return JointResult(
        jobs=list(jobs), shifts=shifts, base_ms=float(unified.base_ms),
        muls=unified.muls, schemes=schemes, offsets_ms=offsets,
        score=worst, psi=result.psi, feasible=worst >= PERFECT - _EPS,
        n_evaluated=result.n_evaluated,
    )


def _copy_joint(jr: JointResult) -> JointResult:
    return JointResult(
        jobs=list(jr.jobs), shifts=np.array(jr.shifts, copy=True),
        base_ms=jr.base_ms, muls=np.array(jr.muls, copy=True),
        schemes={l: _copy_scheme(s) for l, s in jr.schemes.items()},
        offsets_ms=dict(jr.offsets_ms), score=jr.score, psi=jr.psi,
        feasible=jr.feasible, n_evaluated=jr.n_evaluated,
    )


def _solve_joint_problem(prob: JointProblem, *, mode: str,
                         rotation_mode: str, di_pre: int, backend: str,
                         max_exhaustive: int, chunk: int,
                         device: str) -> JointResult:
    psi_of = _joint_psi_of(prob, di_pre)
    n_total = scoring.total_combos(prob.ranges)
    if n_total > max_exhaustive:
        result = _joint_coordinate_descent(
            prob.patterns, prob.bw_lp, prob.caps, prob.unified.muls,
            prob.ranges, psi_of, optimize_psi=(mode == "optimal"))
    else:
        banks = scoring.rolled_bank(prob.patterns, prob.ranges)
        result = _joint_exhaustive(
            prob.patterns, prob.bw_lp, prob.caps, prob.ranges, banks,
            psi_of, mode=mode, rotation_mode=rotation_mode,
            backend=backend, chunk=chunk, device=device)
    return _finish_joint(prob, result, di_pre)


def joint_solve(
    view: LinkView,
    registry,
    links: Sequence[str],
    *,
    jobs: Optional[Sequence[str]] = None,
    mode: str = "fast",
    demand: str = "planning",
    rotation_mode: str = "intermediate",
    di_pre: int = DI_PRE,
    g_t_ms: float = 5.0,
    e_t_frac: float = 0.10,
    backend: str = "numpy",
    max_exhaustive: int = 1 << 22,
    chunk: int = 8192,
    cache: Optional[PlanCache] = None,
    device: str = "cuda",
) -> Optional[JointResult]:
    """Solve one affinity component jointly over every link it touches.

    One global shift per job; Eq. 18 evaluated simultaneously on all links
    (min over links), Eq. 15 ranges on the shared base circle, Eq. 16
    reference pinned, Eq. 9 Psi (min over links) as the tie-break among
    perfect-run midpoints in ``mode='optimal'``; ``mode='fast'`` returns the
    middle of the first jointly perfect run (``rotation_mode='compact'`` is
    the no-cushion ablation).  Returns None when a job has no tasks in the
    view (stale scheme — the caller falls back to the BFS merge).

    With a ``cache``, results are memoized on the problem content within the
    view's epoch (see :class:`PlanCache`); cached results are returned as
    deep copies so consumer mutation never leaks back.

    ``device`` is where ``backend='kernel'`` scores: the CUDA score kernel
    on ``"cuda"`` (raising where no card is present), its plain PyTorch
    version on ``"cpu"``; the ``numpy`` backend ignores it."""
    prob = _build_joint_problem(
        view, registry, links, jobs, mode=mode, demand=demand,
        rotation_mode=rotation_mode, di_pre=di_pre, g_t_ms=g_t_ms,
        e_t_frac=e_t_frac, backend=backend, max_exhaustive=max_exhaustive,
        device=device)
    if prob is None:
        return None
    if cache is not None:
        hit = cache.get(view.epoch, prob.key)
        if hit is not None:
            return _copy_joint(hit)
    result = _solve_joint_problem(
        prob, mode=mode, rotation_mode=rotation_mode, di_pre=di_pre,
        backend=backend, max_exhaustive=max_exhaustive, chunk=chunk,
        device=device)
    if cache is not None:
        cache.put(view.epoch, prob.key, _copy_joint(result))
    return result


def joint_solve_batch(
    specs: Sequence[Tuple[LinkView, Sequence[str]]],
    registry,
    *,
    mode: str = "fast",
    demand: str = "planning",
    rotation_mode: str = "intermediate",
    di_pre: int = DI_PRE,
    g_t_ms: float = 5.0,
    e_t_frac: float = 0.10,
    backend: str = "numpy",
    max_exhaustive: int = 1 << 22,
    chunk: int = 8192,
    cache: Optional[PlanCache] = None,
    device: str = "cuda",
) -> List[Optional[JointResult]]:
    """Solve MANY joint problems (one per ``(view, links)`` spec) with one
    shared enumeration pass per problem family.

    The Score phase produces one such problem per surviving candidate node
    of a pod; the candidates share the component's job set — hence identical
    ``(patterns, ranges)`` — and differ only in the per-link demand banks
    (the candidate delta).  Problems of one family are therefore scored
    together: every chunk of the combo space is evaluated for ALL still-
    unresolved problems in one batched call (``backend='kernel'``: a single
    stacked ``(C, L, R, S)`` kernel dispatch covering the whole space), and
    each problem's run scan consumes its own row — bit-for-bit the result
    :func:`joint_solve` would produce for it individually.

    Results land in ``cache`` (when given), so a subsequent per-candidate
    ``plan()``/``resolve()`` pass hits instead of re-solving.  ``device`` as
    in :func:`joint_solve`."""
    probs: List[Optional[JointProblem]] = []
    for view, links in specs:
        probs.append(_build_joint_problem(
            view, registry, links, None, mode=mode, demand=demand,
            rotation_mode=rotation_mode, di_pre=di_pre, g_t_ms=g_t_ms,
            e_t_frac=e_t_frac, backend=backend,
            max_exhaustive=max_exhaustive, device=device))

    results: List[Optional[JointResult]] = [None] * len(probs)
    epochs = [view.epoch for view, _ in specs]

    # families: identical (patterns, ranges, n_total) solve together
    todo: Dict[Tuple, List[int]] = {}
    seen_keys: Dict[Tuple, int] = {}
    for i, prob in enumerate(probs):
        if prob is None:
            continue
        if cache is not None:
            hit = cache.get(epochs[i], prob.key)
            if hit is not None:
                results[i] = _copy_joint(hit)
                continue
        if prob.key in seen_keys:
            continue  # duplicate problem: filled from the first solve below
        seen_keys[prob.key] = i
        n_total = scoring.total_combos(prob.ranges)
        fam = (prob.patterns.tobytes(), tuple(prob.ranges), n_total)
        todo.setdefault(fam, []).append(i)

    for fam, members in todo.items():
        group = [probs[i] for i in members]
        if len(group) == 1 or scoring.total_combos(
                group[0].ranges) > max_exhaustive:
            for i in members:
                results[i] = _solve_joint_problem(
                    probs[i], mode=mode, rotation_mode=rotation_mode,
                    di_pre=di_pre, backend=backend,
                    max_exhaustive=max_exhaustive, chunk=chunk,
                    device=device)
        else:
            solved = _solve_joint_family(
                group, mode=mode, rotation_mode=rotation_mode,
                di_pre=di_pre, backend=backend, chunk=chunk, device=device)
            for i, res in zip(members, solved):
                results[i] = res

    # propagate duplicates and fill the cache
    for i, prob in enumerate(probs):
        if prob is None or results[i] is not None:
            continue
        src = seen_keys.get(prob.key)
        if src is not None and results[src] is not None:
            results[i] = _copy_joint(results[src])
    if cache is not None:
        for i, prob in enumerate(probs):
            if prob is not None and results[i] is not None:
                cache.put(epochs[i], prob.key, _copy_joint(results[i]))
    return results


def _solve_joint_family(probs: List[JointProblem], *, mode: str,
                        rotation_mode: str, di_pre: int, backend: str,
                        chunk: int, device: str) -> List[JointResult]:
    """One enumeration pass over a family of joint problems sharing
    (patterns, ranges): all still-unresolved problems score every chunk in
    one batched evaluation; each problem's scan state machine is fed its own
    min-over-links row, which makes the outcome chunk-layout independent and
    therefore identical to the per-problem solve."""
    base = probs[0]
    ranges = base.ranges
    n_total = scoring.total_combos(ranges)
    banks = scoring.rolled_bank(base.patterns, ranges)
    scans = [
        _RunScan(ranges, n_total, mode=mode, rotation_mode=rotation_mode,
                 psi_of=_joint_psi_of(p, di_pre), eval_scale=len(p.caps))
        for p in probs
    ]

    if backend == "kernel":
        stacked = _kernel_joint_scores_batch(probs, banks, ranges, device)
        if stacked is not None:
            for scan, js in zip(scans, stacked):
                scan.feed(0, js)
            return [_finish_joint(p, scan.finish(), di_pre)
                    for p, scan in zip(probs, scans)]

    # stack every problem's (L, P) rows; slice per problem after scoring
    row_of: List[Tuple[int, int]] = []
    bw_rows = []
    cap_rows = []
    for p in probs:
        start = len(bw_rows)
        bw_rows.extend(list(p.bw_lp))
        cap_rows.extend(list(p.caps))
        row_of.append((start, start + len(p.caps)))
    bw_rows = np.asarray(bw_rows, dtype=np.float64)
    cap_rows = np.asarray(cap_rows, dtype=np.float64)

    # the block buffer scales with the number of stacked rows: shrink the
    # per-chunk combo budget accordingly (the scan is chunk-invariant, so
    # results are unchanged) to keep memory at the per-problem level; the
    # minor-product floor keeps the gather-free block path usable
    chunk = max(scoring.minor_product(ranges),
                int(chunk) // max(1, len(probs)))

    pending = set(range(len(probs)))
    for pos, block in _score_chunks(base.patterns, bw_rows, cap_rows,
                                    ranges, banks, chunk):
        for pi in sorted(pending):
            lo, hi = row_of[pi]
            js = np.minimum.reduce(block[lo:hi], axis=0)
            if scans[pi].feed(pos, js):
                pending.discard(pi)
        if not pending:
            break
    return [_finish_joint(p, scan.finish(), di_pre)
            for p, scan in zip(probs, scans)]


def _kernel_joint_scores_batch(probs: List[JointProblem], banks, ranges,
                               device: str) -> Optional[List[np.ndarray]]:
    """Full-space joint scores for a problem family via ONE stacked
    (C, L, R, S) kernel launch on ``device``; None when the pairwise layout
    does not apply (!= 2 free jobs).  Problems with fewer links than the
    family maximum are padded with zero-demand unit-capacity links, which
    score a constant 100 and cannot change the min."""
    free = [i for i, r in enumerate(ranges) if r > 1]
    if len(free) != 2:
        return None
    pa, pb = free
    c = len(probs)
    l_max = max(len(p.caps) for p in probs)
    s = probs[0].patterns.shape[1]
    ra, rb = ranges[pa], ranges[pb]
    base = np.zeros((c, l_max, s))
    bank_a = np.zeros((c, l_max, ra, s))
    bank_b = np.zeros((c, l_max, rb, s))
    caps = np.ones((c, l_max))
    for ci, p in enumerate(probs):
        l = len(p.caps)
        caps[ci, :l] = p.caps
        for i in range(p.patterns.shape[0]):
            if i not in (pa, pb):
                base[ci, :l] += p.bw_lp[:, i:i + 1] * p.patterns[i][None, :]
        bank_a[ci, :l] = p.bw_lp[:, pa, None, None] * banks[pa][None, :, :]
        bank_b[ci, :l] = p.bw_lp[:, pb, None, None] * banks[pb][None, :, :]
    scores = kops.score_multilink_batch(base, bank_a, bank_b, caps,
                                        device=device)
    # C-order flatten == lexicographic combo order (free job a is the more
    # significant digit; every other range is 1)
    return [np.asarray(scores[ci]).reshape(-1) for ci in range(c)]


def _joint_exhaustive(patterns, bw_lp, caps, ranges, banks, psi_of, *,
                      mode, rotation_mode, backend, chunk,
                      device) -> RotationResult:
    n_total = scoring.total_combos(ranges)
    scan = _RunScan(ranges, n_total, mode=mode, rotation_mode=rotation_mode,
                    psi_of=psi_of, eval_scale=len(caps))
    if backend == "kernel":
        joint_all = _kernel_joint_scores(patterns, bw_lp, caps, ranges, banks,
                                         device)
        if joint_all is not None:
            scan.feed(0, joint_all)
            return scan.finish()
    for pos, block in _score_chunks(patterns, np.asarray(bw_lp),
                                    np.asarray(caps), ranges, banks, chunk):
        js = np.minimum.reduce(block, axis=0)
        if scan.feed(pos, js):
            break
    return scan.finish()


def _joint_coordinate_descent(patterns, bw_lp, caps, muls, ranges, psi_of, *,
                              optimize_psi, sweeps: int = 4) -> RotationResult:
    """Coordinate descent over jobs with the joint (min-over-links) score."""
    p = patterns.shape[0]
    shifts = np.zeros(p, dtype=np.int64)
    n_eval = 0
    for _ in range(sweeps):
        changed = False
        for i in range(p):
            if ranges[i] <= 1:
                continue
            cands = np.tile(shifts, (ranges[i], 1))
            cands[:, i] = np.arange(ranges[i])
            js = _min_link_scores(patterns, bw_lp, caps, cands, None)
            n_eval += ranges[i] * len(caps)
            best = js.max()
            mask = js >= best - _EPS
            idxs = np.nonzero(mask)[0]
            if optimize_psi and best >= PERFECT - _EPS:
                psis = [psi_of(cands[k]) for k in idxs]
                pick = int(idxs[int(np.argmax(psis))])
            else:
                runs = np.split(idxs, np.where(np.diff(idxs) != 1)[0] + 1)
                pick = int(runs[0][len(runs[0]) // 2])
            if pick != shifts[i]:
                shifts[i] = pick
                changed = True
        if not changed:
            break
    final = _min_link_scores(patterns, bw_lp, caps, shifts[None, :], None)[0]
    return RotationResult(float(final), shifts, final >= PERFECT - _EPS,
                          psi_of(shifts), n_eval)


# ---------------------------------------------------------------------------
# Global resolution: consistent BFS merge or joint re-solve per component
# ---------------------------------------------------------------------------

def _affinity_graph(schemes: Dict[str, LinkScheme],
                    di_pre: int = DI_PRE) -> _graph.Graph:
    """The per-link relative-shift affinity graph of :func:`resolve`, in the
    canonical deterministic construction order (sorted hosts, uplinks
    last): for consistent components any order gives the same offsets; for
    the joint=False ablation it reproduces the legacy tie-break."""
    g = _graph.Graph()
    link_shift_ms: Dict[Tuple[str, str], float] = {}
    ordered = sorted(schemes.items(), key=lambda kv: (is_uplink(kv[0]), kv[0]))
    for link_id, sch in ordered:
        delays = geometry.shifts_to_delay_ms(sch.shifts_slots, sch.base_ms,
                                             di_pre)
        for j, d in zip(sch.jobs, delays):
            link_shift_ms[(link_id, j)] = float(d)
            g.add_node(j)
        for i in range(len(sch.jobs)):
            for k in range(i + 1, len(sch.jobs)):
                a, b = sch.jobs[i], sch.jobs[k]
                rel = (link_shift_ms[(link_id, b)]
                       - link_shift_ms[(link_id, a)])
                if g.has_edge(a, b):
                    if g[a][b]["src"] != a:
                        rel = -rel
                    g[a][b]["rels"].append(rel)
                else:
                    g.add_edge(a, b, rels=[rel], src=a)
    return g


def _components(schemes: Dict[str, LinkScheme], di_pre: int
                ) -> Tuple[_graph.Graph, List[Tuple[set, List[str], bool]]]:
    """The affinity graph plus, per connected component in iteration
    order, ``(component_jobs, component_links, conflicted)`` — the ONE
    conflict decision both :func:`resolve` and the scheduler's warm
    pre-pass consume (so they can never drift apart)."""
    g = _affinity_graph(schemes, di_pre)
    comps: List[Tuple[set, List[str], bool]] = []
    for comp in _graph.connected_components(g):
        comp = set(comp)
        sub = g.subgraph(comp)
        conflicted = any(
            max(d["rels"]) - min(d["rels"]) > REL_TOL_MS
            for _, _, d in sub.edges(data=True)
        )
        comp_links = [lid for lid, sch in schemes.items()
                      if any(j in comp for j in sch.jobs)]
        comps.append((comp, comp_links, conflicted))
    return g, comps


def conflicted_components(schemes: Dict[str, LinkScheme],
                          di_pre: int = DI_PRE
                          ) -> List[Tuple[List[str], bool]]:
    """``[(component_links, conflicted)]`` in :func:`resolve`'s component
    iteration order — the pre-pass the scheduler uses to collect every
    joint problem a subsequent ``plan()`` would solve, without solving."""
    _g, comps = _components(schemes, di_pre)
    return [(comp_links, conflicted)
            for _comp, comp_links, conflicted in comps]


def resolve(
    schemes: Dict[str, LinkScheme],
    priorities: Dict[str, int],
    view: Optional[LinkView],
    registry=None,
    *,
    di_pre: int = DI_PRE,
    mode: str = "fast",
    demand: str = "planning",
    g_t_ms: float = 5.0,
    e_t_frac: float = 0.10,
    rotation_mode: str = "intermediate",
    joint: bool = True,
    backend: str = "numpy",
    cache: Optional[PlanCache] = None,
    device: str = "cuda",
) -> PlanResult:
    """Assign each job one global circle offset from a set of per-link
    schemes (Cassini-style affinity graph anchored at the highest-priority
    job — the paper's difference vs Cassini's random reference, Eq. 16).

    Components whose per-link relative shifts all agree keep their schemes
    and the BFS traversal of the pre-planner controller bit-for-bit.  A
    component with CONFLICTING per-link shifts is re-solved jointly from the
    live ``view`` (``joint=True``); with ``joint=False`` — or when no view
    is available — the legacy reconciliation applies: links are traversed
    in canonical order (host links sorted, uplinks LAST) and the last
    writer wins, i.e. the most oversubscribed tier takes precedence."""
    g, comps = _components(schemes, di_pre)

    offsets: Dict[str, float] = {}
    joint_links: List[str] = []
    new_schemes: Dict[str, LinkScheme] = dict(schemes)
    n_eval = 0
    for comp, comp_links, conflicted in comps:
        if conflicted and joint and view is not None and registry is not None:
            jr = joint_solve(
                view, registry, comp_links, mode=mode, demand=demand,
                rotation_mode=rotation_mode, di_pre=di_pre, g_t_ms=g_t_ms,
                e_t_frac=e_t_frac, backend=backend, cache=cache,
                device=device,
            )
            if jr is not None:
                offsets.update(jr.offsets_ms)
                new_schemes.update(jr.schemes)
                joint_links.extend(comp_links)
                n_eval += jr.n_evaluated
                continue
        # consistent component (or legacy fallback): BFS from the
        # highest-priority reference; the last rel in canonical order is
        # the edge value (== the only value when consistent).
        comp_list = list(comp)
        ref = sorted(comp_list,
                     key=lambda j: (-priorities.get(j, 0), j))[0]
        offsets[ref] = 0.0
        for u, v in _graph.bfs_edges(g, ref):
            rel = g[u][v]["rels"][-1]
            if g[u][v]["src"] != u:
                rel = -rel
            offsets[v] = offsets[u] + rel

    scores = [sch.score for sch in new_schemes.values()]
    worst = min(scores) if scores else PERFECT
    return PlanResult(
        schemes=new_schemes, offsets_ms=offsets, score=worst,
        feasible=worst >= PERFECT - _EPS, joint_links=joint_links,
        n_evaluated=n_eval,
    )


# ---------------------------------------------------------------------------
# Top-level: per-link solve + conflict resolution in one call
# ---------------------------------------------------------------------------

def plan(
    view: LinkView,
    registry,
    *,
    links: Optional[Sequence[str]] = None,
    self_job: Optional[str] = None,
    mode: str = "fast",
    demand: str = "planning",
    di_pre: int = DI_PRE,
    g_t_ms: float = 5.0,
    e_t_frac: float = 0.10,
    rotation_mode: str = "intermediate",
    joint: bool = True,
    backend: str = "numpy",
    cache: Optional[PlanCache] = None,
    device: str = "cuda",
) -> PlanResult:
    """The planner entry point: solve every (given or contended) link, then
    resolve the per-link solutions into one consistent set of global
    offsets.  On star topologies — or whenever the per-link solutions
    already agree — this reduces bit-for-bit to the per-link solve."""
    link_ids = list(links) if links is not None else view.planning_links()
    schemes: Dict[str, LinkScheme] = {}
    worst = PERFECT
    for lid in link_ids:
        score, scheme = solve_link(
            view, registry, lid, self_job=self_job, mode=mode, demand=demand,
            di_pre=di_pre, g_t_ms=g_t_ms, e_t_frac=e_t_frac,
            rotation_mode=rotation_mode, cache=cache,
        )
        worst = min(worst, score)
        if scheme is not None:
            schemes[lid] = scheme
    if not schemes:
        return PlanResult(schemes={}, offsets_ms={}, score=worst,
                          feasible=worst >= PERFECT - _EPS, joint_links=[])
    if len(schemes) == 1:
        # single contended link: nothing to resolve — offsets are the
        # scheme's own delays (BFS from the priority-0 reference would
        # yield exactly these, ref delay being 0 per Eq. 16)
        (lid, sch), = schemes.items()
        delays = geometry.shifts_to_delay_ms(sch.shifts_slots, sch.base_ms,
                                             di_pre)
        return PlanResult(
            schemes=schemes,
            offsets_ms={j: float(d) for j, d in zip(sch.jobs, delays)},
            score=worst, feasible=worst >= PERFECT - _EPS, joint_links=[])
    priorities = {j: (registry.jobs[j].priority if j in registry.jobs else 0)
                  for sch in schemes.values() for j in sch.jobs}
    res = resolve(
        schemes, priorities, view, registry, di_pre=di_pre, mode=mode,
        demand=demand, g_t_ms=g_t_ms, e_t_frac=e_t_frac,
        rotation_mode=rotation_mode, joint=joint, backend=backend,
        cache=cache, device=device,
    )
    # resolve()'s schemes carry the FINAL per-link scores (a jointly
    # re-solved component replaces the stale per-link ones); early-return
    # links contribute exactly PERFECT and cannot lower the worst score
    return res
