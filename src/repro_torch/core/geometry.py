"""Geometric (TDM circle) abstraction of periodic traffic — paper section II-B.

A group of tasks sharing a link is unified to a base period
``T_l = LCM(t_1..t_p)`` and each task's traffic pattern becomes ``mul_p``
equally spaced communication arcs on a circle of perimeter ``T_l``
(Eqs. 1-3). The circle is discretized into ``Di-Pre`` slots (the paper uses
72, after Cassini); rotation angles become integer slot shifts.

All hot paths are vectorized (numpy here; the enumeration over rotation
schemes additionally has a CUDA implementation in
``repro_torch.kernels.metronome_score``).
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Optional, Sequence

import numpy as np

DI_PRE = 72  # angular discretization precision (paper section IV-A, after Cassini)


# ---------------------------------------------------------------------------
# Period unification (LCM with G_T averaging and E_T idle injection)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class UnifiedPeriods:
    """Result of unifying task periods onto one circle.

    base_ms    : the base period T_l (circle perimeter).
    muls       : mul_p — how many times each task's pattern repeats.
    periods_ms : effective per-task period after averaging/injection.
    injected_ms: idle time injected into each task's compute phase (E_T rule).
    ok         : False -> the task could not be made commensurate (the caller
                 must treat the group as incompatible, paper snapshot 0).
    """

    base_ms: float
    muls: np.ndarray
    periods_ms: np.ndarray
    injected_ms: np.ndarray
    ok: np.ndarray


# content-keyed memo: unification is a pure function of its inputs and the
# scheduler re-derives the same groups for every candidate node of a pod
_UNIFY_CACHE: dict = {}
_UNIFY_CACHE_MAX = 512
# guards both memos: sweep(mode="thread") runs simulations concurrently
_CACHE_LOCK = threading.Lock()


def unify_periods(
    periods_ms: Sequence[float],
    priorities: Optional[Sequence[int]] = None,
    *,
    g_t_ms: float = 5.0,
    e_t_frac: float = 0.10,
    max_mul: int = 16,
) -> UnifiedPeriods:
    """Find a common base period T_l for a set of task periods.

    Implements the paper's two thresholds (section III-B):
      - if the mismatch between a task's period and the nearest integer
        divisor of the base is <= ``G_T`` -> merge by averaging;
      - if the mismatch is in (G_T, E_T * period] -> inject idle time into
        the task's computation phase (only meaningful for low priority
        tasks; the caller enforces priority semantics);
      - otherwise the task is flagged not-ok (incompatible).

    The base period is anchored on the highest-priority task (its period is
    never altered — Eq. 16's "reference" semantics), scanning multipliers up
    to ``max_mul``.
    """
    key = (tuple(float(p) for p in periods_ms),
           None if priorities is None else tuple(int(p) for p in priorities),
           g_t_ms, e_t_frac, max_mul)
    hit = _UNIFY_CACHE.get(key)
    if hit is not None:
        # arrays copied out: LinkScheme consumers rebind/slice them freely
        return UnifiedPeriods(hit.base_ms, hit.muls.copy(),
                              hit.periods_ms.copy(), hit.injected_ms.copy(),
                              hit.ok.copy())
    periods = np.asarray(periods_ms, dtype=np.float64)
    n = len(periods)
    if priorities is None:
        priorities = [0] * n
    prios = np.asarray(priorities)

    # reference: highest priority, ties -> earliest (lowest index)
    ref = int(np.lexsort((np.arange(n), -prios))[0])
    t_ref = periods[ref]

    best: Optional[UnifiedPeriods] = None
    best_bad = n + 1
    # scan multipliers ASCENDING and take the first base where every task is
    # commensurate — an "excessively large LCM period would significantly
    # complicate the scheduling calculation" (section III-B).
    for m_ref in range(1, max_mul + 1):
        base = t_ref * m_ref
        muls = np.maximum(1, np.round(base / periods)).astype(np.int64)
        if np.any(muls > max_mul * 4):
            continue
        eff = base / muls  # implied per-task period
        delta = eff - periods  # >0 -> task must slow down (idle injection)
        ok = np.abs(delta) <= g_t_ms
        inject = np.zeros(n)
        # E_T rule: inject idle when the implied period is LONGER by more
        # than G_T but within E_T fraction of the task's own period. Idle is
        # only ever injected into LOW priority pods (the paper never slows a
        # high priority job).
        low = prios < prios[ref] if np.any(prios != prios[ref]) else prios == prios
        low = np.asarray(low) & (np.arange(n) != ref)
        need_inject = (~ok) & (delta > 0) & (delta <= e_t_frac * periods) & low
        # Also compensate sub-G_T positive mismatches of low-priority tasks:
        # without it the task's comm phase drifts by |delta| every iteration
        # and the monitor must re-align continuously (defeats the cushion).
        need_inject |= ok & (delta > g_t_ms * 0.0) & (delta > 0) & low
        inject[need_inject] = delta[need_inject]
        ok = ok | need_inject
        n_bad = int(np.sum(~ok))
        if n_bad < best_bad:
            best_bad = n_bad
            best = UnifiedPeriods(
                base_ms=float(base),
                muls=muls,
                periods_ms=eff,
                injected_ms=inject,
                ok=ok,
            )
        if n_bad == 0:
            break  # smallest feasible base period found
    assert best is not None
    with _CACHE_LOCK:
        if len(_UNIFY_CACHE) >= _UNIFY_CACHE_MAX:
            _UNIFY_CACHE.clear()
        _UNIFY_CACHE[key] = UnifiedPeriods(
            best.base_ms, best.muls.copy(), best.periods_ms.copy(),
            best.injected_ms.copy(), best.ok.copy())
    return best


# ---------------------------------------------------------------------------
# Discretized traffic patterns
# ---------------------------------------------------------------------------

def pattern_vector(mul: int, duty: float, n_slots: int = DI_PRE) -> np.ndarray:
    """Boolean comm-phase indicator over the discretized circle (Eq. 2).

    ``duty`` is the task's duty cycle w.r.t. its own (effective) period, so a
    single communication arc spans ``duty * n_slots / mul`` slots and repeats
    ``mul`` times at offsets ``i * n_slots / mul``.
    """
    pat = np.zeros(n_slots, dtype=np.float64)
    if duty <= 0:
        return pat
    arc = duty * n_slots / mul  # slots per communication burst
    for i in range(mul):
        start = i * n_slots / mul
        # cover [start, start+arc) with partial-slot weighting at the edges
        a, b = start, start + arc
        lo, hi = int(math.floor(a)), int(math.ceil(b))
        for s in range(lo, hi):
            cover = min(b, s + 1) - max(a, s)
            if cover > 0:
                pat[s % n_slots] += cover
    return np.minimum(pat, 1.0)


# content-keyed memo for the (pure) pattern construction; callers treat
# pattern matrices as read-only (they are only ever scored or rolled)
_PATTERN_CACHE: dict = {}
_PATTERN_CACHE_MAX = 512


def pattern_matrix(
    muls: Sequence[int], duties: Sequence[float], n_slots: int = DI_PRE
) -> np.ndarray:
    """(P, S) matrix of per-task comm indicators (read-only: cached by
    content — the per-slot construction loops are pure Python)."""
    key = (tuple(int(m) for m in muls), tuple(float(d) for d in duties),
           n_slots)
    hit = _PATTERN_CACHE.get(key)
    if hit is not None:
        return hit
    out = np.stack(
        [pattern_vector(int(m), float(d), n_slots) for m, d in zip(muls, duties)]
    )
    with _CACHE_LOCK:
        if len(_PATTERN_CACHE) >= _PATTERN_CACHE_MAX:
            _PATTERN_CACHE.clear()
        _PATTERN_CACHE[key] = out
    return out


def roll_patterns(patterns: np.ndarray, shifts: np.ndarray) -> np.ndarray:
    """Rotate each task's pattern by its integer slot shift theta_{l,p}."""
    p, s = patterns.shape
    idx = (np.arange(s)[None, :] - np.asarray(shifts)[:, None]) % s
    return np.take_along_axis(patterns, idx, axis=1)


def demand(patterns: np.ndarray, bw: np.ndarray, shifts: np.ndarray) -> np.ndarray:
    """Total bandwidth demand S_l(theta) over the circle (Eq. 4)."""
    rolled = roll_patterns(patterns, shifts)
    return np.einsum("p,ps->s", np.asarray(bw, dtype=np.float64), rolled)


def link_utilization(
    patterns: np.ndarray, bw: np.ndarray, shifts: np.ndarray, capacity: float
) -> float:
    """xi_l — Eq. (6): integral of min(S_l, B_l) / integral of B_l."""
    s = demand(patterns, bw, shifts)
    return float(np.mean(np.minimum(s, capacity)) / capacity)


def avg_bw_utilization(per_link_util: Sequence[float], capacities: Sequence[float],
                       b_max: float) -> float:
    """Gamma — Eq. (5): capacity-weighted average across links."""
    caps = np.asarray(capacities, dtype=np.float64)
    utils = np.asarray(per_link_util, dtype=np.float64)
    if len(caps) == 0:
        return 0.0
    return float(np.mean(caps * utils / b_max))


def excess(patterns: np.ndarray, bw: np.ndarray, shifts: np.ndarray,
           capacity: float) -> float:
    """Sum over slots of demand exceeding the link capacity (Eq. 18 numerator)."""
    s = demand(patterns, bw, shifts)
    return float(np.sum(np.maximum(s - capacity, 0.0)))


def score(patterns: np.ndarray, bw: np.ndarray, shifts: np.ndarray,
          capacity: float) -> float:
    """Node bandwidth score — Eq. (18), scaled to [0, 100].

    100 <=> the wait pod is fully compatible (no slot exceeds capacity).
    """
    n_slots = patterns.shape[1]
    ex = excess(patterns, bw, shifts, capacity)
    return float(max(0.0, 100.0 * (1.0 - ex / (capacity * n_slots))))


# ---------------------------------------------------------------------------
# Communication intervals and the Psi (cushion) metric — Eq. (9)
# ---------------------------------------------------------------------------

def comm_midpoints(mul: int, duty: float, shift: int, n_slots: int = DI_PRE) -> np.ndarray:
    """Circle angles (in slots) of the midpoints of each communication arc."""
    arc = duty * n_slots / mul
    starts = np.arange(mul) * (n_slots / mul) + shift
    return (starts + arc / 2.0) % n_slots


def circular_distance(a: np.ndarray, b: np.ndarray, n_slots: int = DI_PRE) -> np.ndarray:
    """Distance(phi, psi) = min(|phi-psi|, 2pi - |phi-psi|) in slot units."""
    d = np.abs(a[..., :, None] - b[..., None, :])
    return np.minimum(d, n_slots - d)


def min_comm_interval(
    muls: Sequence[int],
    duties: Sequence[float],
    bw: Sequence[float],
    shifts: Sequence[int],
    capacity: float,
    n_slots: int = DI_PRE,
) -> float:
    """Psi — Eq. (9): min circular distance between arc midpoints of every
    *contending* task pair (pairs whose combined demand >= link capacity)."""
    k = len(muls)
    best = math.inf
    for i in range(k):
        for j in range(i + 1, k):
            if bw[i] + bw[j] < capacity:
                continue  # not contending
            mi = comm_midpoints(int(muls[i]), float(duties[i]), int(shifts[i]), n_slots)
            mj = comm_midpoints(int(muls[j]), float(duties[j]), int(shifts[j]), n_slots)
            best = min(best, float(np.min(circular_distance(mi, mj, n_slots))))
    return best if best < math.inf else float(n_slots)


# ---------------------------------------------------------------------------
# Conversions
# ---------------------------------------------------------------------------

def shifts_to_delay_ms(shifts: np.ndarray, base_ms: float, n_slots: int = DI_PRE) -> np.ndarray:
    """Rotation angles -> time shifts: Shifts = Ro / Di-Pre * T_l (section III-B)."""
    return np.asarray(shifts, dtype=np.float64) / n_slots * base_ms


def delay_to_shift_slots(delay_ms: float, base_ms: float, n_slots: int = DI_PRE) -> int:
    return int(round(delay_ms / base_ms * n_slots)) % n_slots
