"""Imperfect-information control plane: the telemetry channel model.

Everything upstream of this module assumed an oracle: the monitor, the
Score phase, and ``StopAndWaitController.on_link_change`` read exact,
instantaneous link state.  DESIGN.md section 19 replaces that assumption
with an explicit observation channel:

  * :class:`TelemetryChannel` — the channel configuration (sampling
    period, multiplicative Gaussian noise, staleness, dropout), carried
    on :class:`~repro_torch.core.simulator.SimConfig` so it participates in
    bench fingerprints like every other result-relevant knob.
  * :class:`TelemetryView` — a :class:`~repro_torch.core.cluster.Cluster`
    proxy.  It exposes the full cluster API (delegation), but
    ``link_alloc`` — the single authority every scheduler-side consumer
    reads allocatable bandwidth through (LinkView fill problems,
    ``expected_iteration_ms`` re-baselining, ``on_link_change`` replans)
    — returns the *observed* value: the truth as of the last sample
    time, distorted by the channel.

Determinism contract (satellite: independent RNG streams): per-sample
noise/dropout draws come from ``np.random.SeedSequence(seed,
spawn_key=(TELEMETRY_STREAM, link_index, sample_index))`` — a pure
function of the (link, sample-slot) pair, never of query order.  Two
event loops that interleave observations differently still see identical
channels, and the simulator's jitter stream (``default_rng(seed)``) is
untouched: adding a telemetry channel cannot perturb a golden-pinned
jitter sequence.

Truth is recorded eagerly: the simulator calls :meth:`record_change`
from every capacity-mutating event handler, so a sample taken at time
``t_s`` observes the capacity that was actually in force at ``t_s`` even
if it changed again before the query (last-sample-wins staleness, not
latest-truth-wins).
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

# spawn-key namespace for the telemetry stream (jitter owns the root
# ``default_rng(seed)`` stream; any future stream takes the next integer)
TELEMETRY_STREAM = 1

# EWMA smoothing for the per-link fluctuation (coefficient of variation)
# history that feeds the reconfiguration-aware Score penalty
FLUCT_ALPHA = 0.3


@dataclasses.dataclass(frozen=True)
class TelemetryChannel:
    """Observation-channel configuration (all distortions off by default).

    ``sample_period_ms``  — telemetry arrives every this-many ms; queries
        between samples see the last sample (sample-and-hold).  ``<= 0``
        degenerates to continuous observation: staleness still applies,
        noise/dropout (which are per-sample notions) do not.
    ``noise_std``         — multiplicative Gaussian noise: an observed
        sample is ``true * (1 + N(0, noise_std))``, clamped at 0.
    ``staleness_ms``      — pipeline delay: a query at ``t`` sees the
        sample that had arrived by ``t - staleness_ms``.
    ``dropout``           — probability a sample is lost in transit; the
        previous sample is carried (last-sample-wins).
    """

    sample_period_ms: float = 1000.0
    noise_std: float = 0.0
    staleness_ms: float = 0.0
    dropout: float = 0.0

    def __post_init__(self) -> None:
        if not math.isfinite(self.sample_period_ms):
            raise ValueError("sample_period_ms must be finite")
        if self.noise_std < 0 or not math.isfinite(self.noise_std):
            raise ValueError("noise_std must be finite and >= 0")
        if self.staleness_ms < 0 or not math.isfinite(self.staleness_ms):
            raise ValueError("staleness_ms must be finite and >= 0")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError("dropout must be in [0, 1)")


class TelemetryView:
    """Cluster proxy observing allocatable bandwidth through a channel.

    Reads delegate to the wrapped (authoritative) cluster; only
    ``link_alloc`` is intercepted.  ``link_capacity`` stays truthful on
    purpose: physical capacity is a *declared* quantity (the
    NodeBandwidth CR), not a measurement.  Mutations made through the
    proxy (``node(...).allocate``, ``bump_epoch``) hit the real objects,
    so the scheduling framework can hold the proxy without forking
    state.
    """

    def __init__(self, cluster, channel: TelemetryChannel, *, seed: int):
        self._cluster = cluster
        self.channel = channel
        self._seed = int(seed)
        # wall clock of the simulation; the simulator advances it each tick
        self.now_ms: float = 0.0
        self._link_index: Dict[str, int] = {
            l: i for i, l in enumerate(cluster.link_ids)}
        # eager truth history per link: [(time_ms, alloc_gbps)], sorted
        self._truth: Dict[str, List[Tuple[float, float]]] = {
            l: [(-math.inf, cluster.link_alloc(l))] for l in cluster.link_ids}
        # memoized observations per (link, sample index)
        self._obs: Dict[Tuple[str, int], float] = {}
        # EWMA fluctuation state per link: (last sample idx, mean, var)
        self._fluct: Dict[str, Tuple[int, float, float]] = {}

    # ------------------------------------------------------------- delegation
    def __getattr__(self, name):
        return getattr(self._cluster, name)

    # ------------------------------------------------------------ truth feed
    def record_change(self, now_ms: float,
                      links: Optional[List[str]] = None) -> None:
        """Record the current true allocatable value of ``links`` (default:
        all) at ``now_ms``.  The simulator calls this from every event
        handler that mutates link capacity, so later samples observe the
        truth that held at their sample time."""
        for l in (links if links is not None else self._cluster.link_ids):
            hist = self._truth.get(l)
            if hist is None:  # link unknown to the wrapped cluster
                continue
            val = self._cluster.link_alloc(l)
            if hist[-1][0] == now_ms:
                hist[-1] = (now_ms, val)
            else:
                hist.append((now_ms, val))

    def _truth_at(self, link_id: str, t_ms: float) -> float:
        hist = self._truth[link_id]
        i = bisect.bisect_right(hist, (t_ms, math.inf)) - 1
        return hist[i][1]

    # ----------------------------------------------------------- observation
    def _sample_rng(self, link_id: str, k: int) -> np.random.Generator:
        ss = np.random.SeedSequence(
            self._seed,
            spawn_key=(TELEMETRY_STREAM, self._link_index[link_id], k))
        return np.random.default_rng(ss)

    def _sample(self, link_id: str, k: int) -> float:
        """Observed value of sample ``k`` (memoized; order-independent).

        Walks back through dropped samples to the newest delivered one —
        obs(k) = obs(k-1) when sample k is lost — so the carry chain is a
        pure function of sample indices, not of which queries happened
        to materialize them first."""
        ch = self.channel
        pending: List[int] = []
        j = k
        while True:
            cached = self._obs.get((link_id, j))
            if cached is not None:
                val = cached
                break
            rng = self._sample_rng(link_id, j)
            # draw order is part of the channel contract: dropout first,
            # then (only for delivered samples) the noise draw
            dropped = j > 0 and ch.dropout > 0.0 and rng.random() < ch.dropout
            if dropped:
                pending.append(j)
                j -= 1
                continue
            true = self._truth_at(link_id, j * ch.sample_period_ms)
            if ch.noise_std > 0.0:
                val = max(0.0, true * (1.0 + rng.normal(0.0, ch.noise_std)))
            else:
                val = true
            self._obs[(link_id, j)] = val
            self._update_fluct(link_id, j, val)
            break
        for p in reversed(pending):
            self._obs[(link_id, p)] = val
        return val

    def _sample_index(self, now_ms: float) -> int:
        period = self.channel.sample_period_ms
        t_s = max(0.0, now_ms - self.channel.staleness_ms)
        return int(t_s // period)

    def link_alloc(self, link_id: str) -> float:
        """Allocatable bandwidth as *observed* through the channel."""
        if link_id not in self._truth:
            # unknown links raise exactly like the wrapped cluster would
            return self._cluster.link_alloc(link_id)
        ch = self.channel
        if ch.sample_period_ms <= 0.0:
            # continuous observation: staleness only
            if ch.staleness_ms > 0.0:
                return self._truth_at(
                    link_id, max(0.0, self.now_ms - ch.staleness_ms))
            return self._cluster.link_alloc(link_id)
        return self._sample(link_id, self._sample_index(self.now_ms))

    # ----------------------------------------------------------- fluctuation
    def _update_fluct(self, link_id: str, k: int, obs: float) -> None:
        state = self._fluct.get(link_id)
        if state is None:
            self._fluct[link_id] = (k, obs, 0.0)
            return
        last_k, mean, var = state
        if k <= last_k:  # only advance on newer samples (monotone clock)
            return
        a = FLUCT_ALPHA
        mean_new = (1.0 - a) * mean + a * obs
        var_new = (1.0 - a) * var + a * (obs - mean_new) ** 2
        self._fluct[link_id] = (k, mean_new, var_new)

    def fluctuation(self, link_id: str) -> float:
        """EWMA coefficient of variation (sigma/mu) of the observed
        samples for ``link_id`` — the Score phase's reconfiguration-aware
        penalty input.  0.0 until at least two samples landed."""
        state = self._fluct.get(link_id)
        if state is None:
            return 0.0
        _, mean, var = state
        if mean <= 0.0 or var <= 0.0:
            return 0.0
        return math.sqrt(var) / mean
