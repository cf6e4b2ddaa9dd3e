"""Typed dynamic-environment events for the cluster simulator.

Metronome's third pillar — "adapts to the dynamic environment by monitoring
the cluster and performing reconfiguration operations" (paper section
III-C) — needs a first-class event stream instead of ad-hoc
``(time, job, duty_mult)`` tuples threaded through the harness.  Each event
carries a timestamp (ms on the simulator clock); ``ClusterSimulator.run()``
consumes the merged stream in timestamp order and the stop-and-wait
controller reacts to capacity/background changes by re-deriving rotation
schemes from the live LinkView (DESIGN.md section 10).

Event types:

  * :class:`TrafficChange` — duty-cycle change of one job (batch-size
    change, congestion onset); the path that already existed in the seed.
  * :class:`BackgroundFlowChange` — iPerf3-style unregulated traffic on one
    link starts / ramps up / ramps down / stops.  The cluster manager's
    NodeBandwidth-CR reaction (lower the allocatable share by the observed
    unregulated rate, section III-A) is modeled by ``adjust_allocatable``.
  * :class:`LinkCapacityChange` — the NodeBandwidth-CR update path for any
    link: the manager changes a link's allocatable share (and optionally
    the physical capacity, e.g. a degraded uplink).
  * :class:`JobDeparture` — a job leaves the cluster early (user abort /
    preemption); its flows vanish and its rotation schemes are retired.
  * :class:`LinkFailure` / :class:`LinkRecovery` — fault injection
    (DESIGN.md section 19): a link's capacity AND allocatable share drop
    to 0 and are later restored; :func:`flapping_schedule` builds the
    alternating failure/recovery trains used by the robustness bench.
  * :class:`HostFailure` / :class:`HostRecovery` — a worker node dies:
    its host link fails and every job with a task on it stalls (flows
    dropped); on recovery stalled jobs restart their interrupted
    iteration (pending re-admission).

Streams are validated at the ``run()`` boundary by
:func:`validate_stream`; ``SimConfig.strict_events`` escalates problems
from warn-once-and-drop to a structured :class:`EventValidationError`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Set, Tuple


class UnknownEventTargetWarning(UserWarning):
    """An event named a link/job the simulator does not know.

    The event is ignored (the seed behavior), but silently dropping a
    mistyped link id in a long trace makes experiments quietly wrong — so
    the simulator emits this structured warning ONCE per (kind, name)
    offender.  ``kind`` is ``'link'`` or ``'job'``; ``name`` the unknown
    target; ``time_ms`` the first offending event's firing time."""

    def __init__(self, kind: str, name: str, time_ms: float) -> None:
        self.kind = kind
        self.name = name
        self.time_ms = time_ms
        super().__init__(
            f"ignoring event for unknown {kind} {name!r} "
            f"(first at t={time_ms:.3f}ms); further events for this "
            f"{kind} are dropped silently")


@dataclasses.dataclass(frozen=True)
class Event:
    """Base: anything with a firing time on the simulator clock."""

    time_ms: float


@dataclasses.dataclass(frozen=True)
class TrafficChange(Event):
    """Job ``job`` multiplies its communication duty by ``duty_mult``
    (clipped so the comm phase never exceeds the period).

    ``declared=True`` (the seed behavior) models the job *announcing* the
    change: the profile is updated and the controller replans from it.
    ``declared=False`` models silent drift — the job's actual traffic
    changes but its declared profile does not, so only the controller's
    measured-vs-declared reconciliation (``reconcile=True``) can close
    the gap."""

    job: str
    duty_mult: float
    declared: bool = True


@dataclasses.dataclass(frozen=True)
class BackgroundFlowChange(Event):
    """Set the unregulated background rate on ``link`` to ``rate_gbps``.

    ``rate_gbps <= 0`` stops the background traffic on the link; a positive
    rate starts it or re-rates the existing flow.  With
    ``adjust_allocatable`` (default) the cluster manager mirrors the change
    into the link's allocatable bandwidth (capacity - background rate, the
    NodeBandwidth-CR path) so schedulers and the reconfiguration loop see
    the reduced share."""

    link: str
    rate_gbps: float
    adjust_allocatable: bool = True


@dataclasses.dataclass(frozen=True)
class LinkCapacityChange(Event):
    """NodeBandwidth-CR update for ``link`` (host link id == node name,
    uplinks ``uplink:<leaf>``): set the allocatable share and/or the
    physical capacity.  ``None`` leaves the respective value untouched."""

    link: str
    allocatable_gbps: Optional[float] = None
    capacity_gbps: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class JobDeparture(Event):
    """Job ``job`` leaves the cluster at ``time_ms`` regardless of its
    remaining iterations (user abort / preemption)."""

    job: str


@dataclasses.dataclass(frozen=True)
class LinkFailure(Event):
    """Link ``link`` fails outright: physical capacity and allocatable
    share both drop to 0 until a :class:`LinkRecovery`.  Failing an
    already-failed link is a no-op (flapping schedules may overlap)."""

    link: str


@dataclasses.dataclass(frozen=True)
class LinkRecovery(Event):
    """Link ``link`` comes back.  By default the pre-failure capacity and
    allocatable share are restored; ``capacity_gbps`` recovers at a
    degraded physical capacity instead.  Recovering a link that is not
    failed is a no-op."""

    link: str
    capacity_gbps: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class HostFailure(Event):
    """Worker node ``host`` dies: its host link fails and every job with
    a task placed on it stalls (in-flight flows drop, the interrupted
    iteration is abandoned) until every failed host of the job has
    recovered."""

    host: str


@dataclasses.dataclass(frozen=True)
class HostRecovery(Event):
    """Worker node ``host`` returns: its host link recovers and jobs
    stalled only on it restart their interrupted iteration."""

    host: str


def flapping_schedule(link: str, *, start_ms: float, period_ms: float,
                      down_ms: float, n_cycles: int,
                      host: bool = False) -> List[Event]:
    """An alternating failure/recovery train: ``n_cycles`` failures of
    ``down_ms`` each, one every ``period_ms`` starting at ``start_ms``.
    ``host=True`` emits host failures instead of link failures."""
    if down_ms >= period_ms:
        raise ValueError("down_ms must be < period_ms (link must recover "
                         "before the next failure)")
    events: List[Event] = []
    for i in range(n_cycles):
        t = start_ms + i * period_ms
        if host:
            events.append(HostFailure(time_ms=t, host=link))
            events.append(HostRecovery(time_ms=t + down_ms, host=link))
        else:
            events.append(LinkFailure(time_ms=t, link=link))
            events.append(LinkRecovery(time_ms=t + down_ms, link=link))
    return events


# ------------------------------------------------- boundary validation
@dataclasses.dataclass(frozen=True)
class EventProblem:
    """One defect found by :func:`validate_stream`.

    ``category`` is ``'bad-value'`` (malformed numbers: NaN times/rates,
    negative capacities) or ``'unknown-target'`` (the event names a
    link/host/job the simulator does not know)."""

    index: int  # position in the (normalized) stream
    category: str
    kind: str  # 'link' | 'host' | 'job' | 'event'
    name: str
    time_ms: float
    message: str


class EventValidationError(ValueError):
    """Raised by ``run(strict_events=True)`` when the event stream has
    problems; carries the full structured list."""

    def __init__(self, problems: Sequence[EventProblem]) -> None:
        self.problems = list(problems)
        lines = "\n".join(f"  - [{p.category}] {p.message}"
                          for p in self.problems)
        super().__init__(
            f"event stream has {len(self.problems)} problem(s):\n{lines}")


def _bad(v: Optional[float]) -> bool:
    return v is not None and not math.isfinite(float(v))


def validate_stream(events: Sequence[Event], *, known_links: Set[str],
                    known_hosts: Set[str],
                    known_jobs: Set[str]) -> List[EventProblem]:
    """Check a normalized stream against the simulator's world.

    Returns every problem found (empty list == valid).  The caller
    decides severity: ``strict_events=True`` raises
    :class:`EventValidationError` on any problem; the default mode
    warn-onces and drops only ``bad-value`` events (unknown targets keep
    the historical fire-time :class:`UnknownEventTargetWarning` path)."""
    problems: List[EventProblem] = []

    def add(i: int, category: str, kind: str, name: str, t: float,
            msg: str) -> None:
        problems.append(EventProblem(index=i, category=category, kind=kind,
                                     name=name, time_ms=t, message=msg))

    for i, ev in enumerate(events):
        t = ev.time_ms
        if _bad(t) or t < 0:
            add(i, "bad-value", "event", type(ev).__name__, t,
                f"{type(ev).__name__} at index {i} has invalid "
                f"time_ms={t!r}")
            continue
        if isinstance(ev, TrafficChange):
            if _bad(ev.duty_mult) or ev.duty_mult <= 0:
                add(i, "bad-value", "job", ev.job, t,
                    f"TrafficChange({ev.job!r}) at t={t:g}ms has invalid "
                    f"duty_mult={ev.duty_mult!r}")
            elif ev.job not in known_jobs:
                add(i, "unknown-target", "job", ev.job, t,
                    f"TrafficChange targets unknown job {ev.job!r}")
        elif isinstance(ev, BackgroundFlowChange):
            if _bad(ev.rate_gbps):
                add(i, "bad-value", "link", ev.link, t,
                    f"BackgroundFlowChange({ev.link!r}) at t={t:g}ms has "
                    f"NaN/inf rate_gbps")
            elif ev.link not in known_links:
                add(i, "unknown-target", "link", ev.link, t,
                    f"BackgroundFlowChange targets unknown link "
                    f"{ev.link!r}")
        elif isinstance(ev, LinkCapacityChange):
            if _bad(ev.allocatable_gbps) or _bad(ev.capacity_gbps) or \
                    (ev.allocatable_gbps is not None
                     and ev.allocatable_gbps < 0) or \
                    (ev.capacity_gbps is not None and ev.capacity_gbps < 0):
                add(i, "bad-value", "link", ev.link, t,
                    f"LinkCapacityChange({ev.link!r}) at t={t:g}ms has "
                    f"negative/NaN capacity "
                    f"(allocatable={ev.allocatable_gbps!r}, "
                    f"capacity={ev.capacity_gbps!r})")
            elif ev.link not in known_links:
                add(i, "unknown-target", "link", ev.link, t,
                    f"LinkCapacityChange targets unknown link {ev.link!r}")
        elif isinstance(ev, (LinkFailure, LinkRecovery)):
            cap = getattr(ev, "capacity_gbps", None)
            if _bad(cap) or (cap is not None and cap < 0):
                add(i, "bad-value", "link", ev.link, t,
                    f"{type(ev).__name__}({ev.link!r}) at t={t:g}ms has "
                    f"negative/NaN capacity_gbps={cap!r}")
            elif ev.link not in known_links:
                add(i, "unknown-target", "link", ev.link, t,
                    f"{type(ev).__name__} targets unknown link {ev.link!r}")
        elif isinstance(ev, (HostFailure, HostRecovery)):
            if ev.host not in known_hosts:
                add(i, "unknown-target", "host", ev.host, t,
                    f"{type(ev).__name__} targets unknown host {ev.host!r}")
        elif isinstance(ev, JobDeparture):
            if ev.job not in known_jobs:
                add(i, "unknown-target", "job", ev.job, t,
                    f"JobDeparture targets unknown job {ev.job!r}")
    return problems


LegacyTrafficChange = Tuple[float, str, float]


def normalize_events(
    events: Sequence[Event] = (),
    traffic_changes: Sequence[LegacyTrafficChange] = (),
) -> List[Event]:
    """Merge typed events with legacy ``(time, job, duty_mult)`` tuples into
    one timestamp-ordered stream.

    Legacy tuples keep their historical full-tuple sort (time, job name,
    multiplier) before conversion; the merged stream is then stably sorted
    by timestamp, so same-time events preserve their relative order."""
    stream: List[Event] = [
        TrafficChange(time_ms=float(t), job=j, duty_mult=float(m))
        for t, j, m in sorted(traffic_changes)
    ]
    stream.extend(events)
    return sorted(stream, key=lambda e: e.time_ms)
