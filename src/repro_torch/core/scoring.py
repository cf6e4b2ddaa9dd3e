"""Per-candidate rotation-scheme evaluators — paper section III-B (Eq. 18).

This module holds the *evaluation* primitives of the rotation search: the
per-task shift ranges of Eq. 15, lexicographic combo decoding, rolled
demand banks, the vectorized Eq. 18 scorer, and the Psi (Eq. 9) metric of a
chosen scheme.  The *search* itself — per-link solvers, the fabric-wide
joint solve, and global-offset resolution — lives in
:mod:`repro_torch.core.rotation`, the single producer of rotation schemes.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np

from . import geometry
from .geometry import DI_PRE

PERFECT = 100.0
_EPS = 1e-9

# (n_slots,) -> the full (S, S) roll-index matrix ROLL[r, j] = (j - r) % S,
# shared by rolled_bank (sliced to the first ``ranges[p]`` rows) and the
# bank-less score_combos fallback (gathered by combo column) instead of
# reallocating the arange outer difference on every call.
_ROLL_IDX: dict = {}
# (patterns bytes, shape, ranges) -> rolled bank; patterns are tiny (P x S)
# so the content key is cheap, and the Score phase re-derives the SAME bank
# for every candidate node of a pod (see repro_torch.core.rotation).
_BANK_CACHE: dict = {}
_BANK_CACHE_MAX = 128
# guards both memos: sweep(mode="thread") runs simulations concurrently
_CACHE_LOCK = threading.Lock()


def roll_index(n_slots: int) -> np.ndarray:
    """The (S, S) matrix of roll gather indices: row r = (arange(S) - r) % S."""
    idx = _ROLL_IDX.get(n_slots)
    if idx is None:
        ar = np.arange(n_slots)
        idx = (ar[None, :] - ar[:, None]) % n_slots
        with _CACHE_LOCK:
            _ROLL_IDX[n_slots] = idx
    return idx


def shift_ranges(muls: Sequence[int], ref_index: int, n_slots: int = DI_PRE) -> List[int]:
    """Per-task rotation search-space sizes: S // mul_p (Eq. 15), ref pinned."""
    out = []
    for i, m in enumerate(muls):
        if i == ref_index:
            out.append(1)
        else:
            out.append(max(1, n_slots // int(m)))
    return out


def rolled_bank(patterns: np.ndarray, ranges: Sequence[int]) -> List[np.ndarray]:
    """bank[p][r] = pattern p rolled by r slots, for r in [0, ranges[p]).

    Content-cached: the bank is a pure function of (patterns, ranges) and the
    scheduler re-requests identical banks for every candidate node of a pod.
    Callers must treat the returned arrays as read-only."""
    p, s = patterns.shape
    key = (patterns.tobytes(), patterns.shape, tuple(int(r) for r in ranges))
    bank = _BANK_CACHE.get(key)
    if bank is None:
        idx = roll_index(s)
        bank = [patterns[i][idx[: ranges[i]]] for i in range(p)]
        with _CACHE_LOCK:
            if len(_BANK_CACHE) >= _BANK_CACHE_MAX:
                _BANK_CACHE.clear()
            _BANK_CACHE[key] = bank
    return bank


def score_combos(
    patterns: np.ndarray,
    bw: np.ndarray,
    capacity: float,
    combos: np.ndarray,
    bank: Optional[List[np.ndarray]] = None,
) -> np.ndarray:
    """Vectorized Eq. (18) score for a (K, P) array of shift combos."""
    p, s = patterns.shape
    k = combos.shape[0]
    total = np.zeros((k, s), dtype=np.float64)
    for i in range(p):
        if bank is not None:
            rolled = bank[i][combos[:, i]]  # (K, S)
        else:
            rolled = patterns[i][roll_index(s)[combos[:, i] % s]]
        total += bw[i] * rolled
    ex = np.sum(np.maximum(total - capacity, 0.0), axis=1)
    if capacity <= 0.0:
        # a dead link (fault injection, DESIGN.md section 19) admits
        # nothing: every scheme scores 0, and 0/0 must not leak NaN
        return np.zeros(k, dtype=np.float64)
    return np.maximum(0.0, 100.0 * (1.0 - ex / (capacity * s)))


def lex_block_scores(
    patterns: np.ndarray,
    bw_rows: np.ndarray,
    capacities: np.ndarray,
    ranges: Sequence[int],
    bank: List[np.ndarray],
    major_start: int,
    major_count: int,
) -> np.ndarray:
    """Eq. (18) scores of a contiguous lexicographic combo span, batched over
    M (bandwidth, capacity) rows — shape (M, major_count * minor_product).

    The span covers every combo whose MOST SIGNIFICANT free digit (the lowest
    pattern index with ``ranges > 1``) lies in
    ``[major_start, major_start + major_count)`` with all lower digits
    enumerated — exactly rows ``[major_start * minor, ...)`` of the
    lexicographic order that :func:`lex_combos` decodes.

    Instead of gathering a rolled row per combo (a (K, S) gather per pattern,
    the old hot path), the demand tensor is built by broadcasting each free
    pattern's bank along its own axis.  Per element the accumulation performs
    the IDENTICAL float64 operation sequence as :func:`score_combos`
    (``total += bw[p] * rolled_p`` in ascending pattern order), so the result
    is bit-for-bit equal to calling ``score_combos`` row by row."""
    p, s = patterns.shape
    bw_rows = np.asarray(bw_rows, dtype=np.float64)
    capacities = np.asarray(capacities, dtype=np.float64)
    squeeze = bw_rows.ndim == 1
    if squeeze:
        bw_rows = bw_rows[None, :]
        capacities = capacities.reshape(1)
    m = bw_rows.shape[0]
    free = [i for i in range(p) if ranges[i] > 1]
    nfree = len(free)
    full = [m] + [1] * nfree + [s]
    for fi, i in enumerate(free):
        full[1 + fi] = (major_count if fi == 0 else ranges[i])
    # one full-shape buffer, accumulated IN PLACE with broadcasting: per
    # element the partial-sum sequence (ascending pattern index) is the
    # same as score_combos', so results stay bit-identical while the big
    # tensor is traversed once per pattern instead of re-allocated.  The
    # first pattern is written by assignment (0.0 + x == x bit-exactly for
    # the non-negative bw*pattern contributions), skipping the zero fill.
    total = np.empty(full, dtype=np.float64)
    for i in range(p):
        if ranges[i] <= 1:
            rows = bank[i][0:1]  # digit pinned at 0
            shape = [1] * nfree + [s]
        else:
            fi = free.index(i)
            if fi == 0:
                rows = bank[i][major_start:major_start + major_count]
            else:
                rows = bank[i]
            shape = [1] * nfree + [s]
            shape[fi] = rows.shape[0]
        contrib = (bw_rows[:, i].reshape((m,) + (1,) * (nfree + 1))
                   * rows.reshape([1] + shape))
        if i == 0:
            total[...] = contrib
        else:
            total += contrib
    total -= capacities.reshape((m,) + (1,) * (nfree + 1))
    np.maximum(total, 0.0, out=total)
    ex = np.sum(total, axis=-1).reshape(m, -1)
    with np.errstate(divide="ignore", invalid="ignore"):
        scores = np.maximum(0.0,
                            100.0 * (1.0 - ex / (capacities[:, None] * s)))
    # dead links (capacity 0, fault injection) score 0, not inf/NaN
    scores = np.where(capacities[:, None] > 0.0, scores, 0.0)
    return scores[0] if squeeze else scores


def minor_product(ranges: Sequence[int]) -> int:
    """Product of every free range BELOW the most significant free digit —
    the span granularity of :func:`lex_block_scores` (1 when <= 1 free)."""
    free = [int(r) for r in ranges if r > 1]
    n = 1
    for r in free[1:]:
        n *= r
    return n


def lex_combos(ranges: Sequence[int], start: int, count: int) -> np.ndarray:
    """Decode lexicographic combo indices [start, start+count) -> (count, P)."""
    idx = np.arange(start, start + count, dtype=np.int64)
    p = len(ranges)
    out = np.zeros((len(idx), p), dtype=np.int64)
    for i in range(p - 1, -1, -1):
        out[:, i] = idx % ranges[i]
        idx = idx // ranges[i]
    return out


def total_combos(ranges: Sequence[int]) -> int:
    n = 1
    for r in ranges:
        n *= r
    return n


def scheme_psi(patterns, bw, capacity, muls, shifts, n_slots=DI_PRE) -> float:
    """Psi (Eq. 9) of one chosen scheme.

    The duty w.r.t. the base circle = total comm slots / n_slots; Eq. 9
    midpoints need the per-task duty cycle (per-burst arc =
    duty * n_slots / mul)."""
    duties = [float(patterns[i].sum() / n_slots) for i in range(len(muls))]
    return geometry.min_comm_interval(muls, duties, bw, shifts, capacity,
                                      n_slots)
