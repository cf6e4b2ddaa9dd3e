"""Gavel-style workload trace generator (paper section IV-A, "Traces").

Generates a job arrival sequence with priorities and durations (0.5-1.5 h)
drawn from the 13-model fleet, targeting a cluster load (fraction of GPUs
serving active jobs) above a configurable threshold. All randomness is
seeded for reproducibility.

Trace truncation can be expressed two ways: the legacy iteration cap
(``trace_to_jobs`` derives ``n_iterations`` from the duration) or the
event-driven form (``open_ended=True`` + :func:`trace_departure_events`):
each job runs until its :class:`~repro_torch.core.events.JobDeparture` fires on
the simulator clock — the K8s behavior where a job's deadline, not a
pre-computed iteration count, ends it.  The event form survives contention
honestly (a slowed job does FEWER iterations in its window instead of
holding its GPUs longer) and feeds a trace scenario's event stream
(``configs.metronome_testbed.trace_scenario``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Mapping, Sequence

import numpy as np

from .events import JobDeparture
from .workload import HIGH, LOW, Job, make_job

# iteration ceiling of open-ended (departure-truncated) jobs: high enough
# that no realistic trace window ever exhausts it
OPEN_ENDED_ITERATIONS = 1_000_000_000


def trace_job_name(spec: "TraceJobSpec", index: int) -> str:
    """Canonical job name of the ``index``-th trace entry (shared by
    :func:`trace_to_jobs` and :func:`trace_departure_events`)."""
    return f"{spec.model.lower()}-{index}"


@dataclasses.dataclass
class TraceJobSpec:
    model: str
    submit_time_s: float
    duration_s: float
    priority: int
    n_tasks: int


def specs_from_records(records: Iterable[Mapping[str, Any]]
                       ) -> List[TraceJobSpec]:
    """Trace entries from plain records: one mapping of the
    :class:`TraceJobSpec` fields (numbers and strings) per job, for example
    ``dataclasses.asdict`` of another implementation's specs, so two
    implementations can be driven with the identical trace."""
    return [TraceJobSpec(model=str(r["model"]),
                         submit_time_s=float(r["submit_time_s"]),
                         duration_s=float(r["duration_s"]),
                         priority=int(r["priority"]),
                         n_tasks=int(r["n_tasks"]))
            for r in records]


def generate_trace(
    model_fleet: Dict[str, dict],
    *,
    duration_s: float = 4 * 3600.0,
    total_gpus: int = 13,
    target_load: float = 0.7,
    high_priority_frac: float = 0.4,
    seed: int = 0,
    job_duration_range_s: Sequence[float] = (1800.0, 5400.0),
) -> List[TraceJobSpec]:
    """Sample a trace. ``model_fleet`` maps model name -> traffic dict with
    keys period_ms/duty/bw_gbps/n_tasks (see configs.metronome_testbed)."""
    rng = np.random.default_rng(seed)
    names = sorted(model_fleet.keys())
    jobs: List[TraceJobSpec] = []
    # Poisson arrivals sized so that expected concurrent GPU demand ~= target
    mean_tasks = float(np.mean([model_fleet[m].get("n_tasks", 2) for m in names]))
    mean_dur = float(np.mean(job_duration_range_s))
    rate = target_load * total_gpus / (mean_tasks * mean_dur)  # jobs per second
    t = 0.0
    i = 0
    while t < duration_s:
        t += float(rng.exponential(1.0 / rate))
        if t >= duration_s:
            break
        model = names[int(rng.integers(len(names)))]
        dur = float(rng.uniform(*job_duration_range_s))
        prio = HIGH if rng.random() < high_priority_frac else LOW
        jobs.append(
            TraceJobSpec(
                model=model,
                submit_time_s=t,
                duration_s=dur,
                priority=prio,
                n_tasks=int(model_fleet[model].get("n_tasks", 2)),
            )
        )
        i += 1
    return jobs


def generate_production_trace(
    model_fleet: Dict[str, dict],
    *,
    n_jobs: int = 10_000,
    duration_s: float = 24 * 3600.0,
    seed: int = 0,
    diurnal_amplitude: float = 0.6,
    peak_hour: float = 14.0,
    day_s: float = 24 * 3600.0,
    median_duration_s: float = 1200.0,
    duration_sigma: float = 1.2,
    duration_clip_s: Sequence[float] = (60.0, 6 * 3600.0),
    high_priority_frac: float = 0.3,
    task_multipliers: Sequence[int] = (1, 2, 4),
    task_weights: Sequence[float] = (0.7, 0.2, 0.1),
) -> List[TraceJobSpec]:
    """Synthetic production trace: diurnal arrivals, heavy-tailed sizes,
    mixed priorities — the 10k-job scale the fluid-engine benchmark and the
    roadmap's learning-to-schedule corpus need (production cluster traces
    look like this; Gavel's constant-rate Poisson does not).

      * Arrivals: a nonhomogeneous Poisson process via thinning with rate
        ``lam(t) = base * (1 + A * cos(2*pi*(t - peak)/day))`` — a diurnal
        sinusoid peaking at ``peak_hour``; ``base`` is sized so the window
        yields ~``n_jobs`` arrivals, then the sequence is clipped/extended
        to exactly ``n_jobs``.
      * Durations: lognormal around ``median_duration_s`` with shape
        ``duration_sigma`` (heavy right tail — most jobs are minutes, a few
        run hours), clipped to ``duration_clip_s``.
      * Sizes: the fleet model's ``n_tasks`` times a multiplier drawn from
        ``task_multipliers``/``task_weights`` (mostly small, few big).
      * Priorities: Bernoulli(``high_priority_frac``).

    Deterministic per seed; entries are sorted by submit time."""
    rng = np.random.default_rng(seed)
    names = sorted(model_fleet.keys())
    amp = min(max(float(diurnal_amplitude), 0.0), 1.0)
    base_rate = n_jobs / duration_s
    lam_max = base_rate * (1.0 + amp)
    peak_s = peak_hour * 3600.0
    lo, hi = duration_clip_s
    weights = np.asarray(task_weights, dtype=float)
    weights = weights / weights.sum()

    jobs: List[TraceJobSpec] = []
    t = 0.0
    while len(jobs) < n_jobs:
        t += float(rng.exponential(1.0 / lam_max))
        if t >= duration_s:
            # sparse tail (rounding of the thinning acceptance): wrap into
            # the next day so the trace always reaches n_jobs entries
            duration_s += day_s
        lam_t = base_rate * (
            1.0 + amp * np.cos(2.0 * np.pi * (t - peak_s) / day_s))
        if rng.random() * lam_max > lam_t:
            continue  # thinned: off-peak candidate rejected
        model = names[int(rng.integers(len(names)))]
        dur = float(np.clip(
            median_duration_s * np.exp(duration_sigma * rng.standard_normal()),
            lo, hi))
        mult = int(rng.choice(np.asarray(task_multipliers), p=weights))
        jobs.append(TraceJobSpec(
            model=model,
            submit_time_s=t,
            duration_s=dur,
            priority=HIGH if rng.random() < high_priority_frac else LOW,
            n_tasks=int(model_fleet[model].get("n_tasks", 2)) * mult,
        ))
    return jobs


def active_jobs_at(trace: Sequence[TraceJobSpec], t_s: float) -> List[int]:
    """Indices of trace entries live at ``t_s`` (submitted, not departed)."""
    return [i for i, spec in enumerate(trace)
            if spec.submit_time_s <= t_s < spec.submit_time_s + spec.duration_s]


def trace_to_jobs(trace: List[TraceJobSpec], model_fleet: Dict[str, dict],
                  time_scale: float = 1.0, *,
                  open_ended: bool = False) -> List[Job]:
    """Materialize Job objects; ``time_scale`` compresses the trace (e.g.
    0.1 -> a 4 h trace plays in 24 min of simulated time).

    ``open_ended=True`` switches truncation from the iteration cap to
    :class:`~repro_torch.core.events.JobDeparture` events: jobs get an
    effectively unbounded iteration budget and the caller feeds
    :func:`trace_departure_events` into the simulator's event stream."""
    jobs = []
    for i, spec in enumerate(trace):
        fleet = model_fleet[spec.model]
        period = fleet["period_ms"]
        if open_ended:
            n_iter = OPEN_ENDED_ITERATIONS
        else:
            n_iter = max(1, int(spec.duration_s * time_scale * 1e3 / period))
        jobs.append(
            make_job(
                trace_job_name(spec, i),
                n_tasks=spec.n_tasks,
                period_ms=period,
                duty=fleet["duty"],
                bw_gbps=fleet["bw_gbps"],
                priority=spec.priority,
                n_iterations=n_iter,
                submit_time_s=spec.submit_time_s * time_scale,
                model=spec.model,
            )
        )
    return jobs


def trace_departure_events(trace: List[TraceJobSpec],
                           time_scale: float = 1.0) -> List[JobDeparture]:
    """The event-driven form of trace truncation: one
    :class:`~repro_torch.core.events.JobDeparture` per trace entry at
    ``(submit + duration) * time_scale`` on the simulator clock (ms).
    Pair with ``trace_to_jobs(..., open_ended=True)``."""
    return [
        JobDeparture(
            time_ms=(spec.submit_time_s + spec.duration_s) * time_scale * 1e3,
            job=trace_job_name(spec, i),
        )
        for i, spec in enumerate(trace)
    ]


def cluster_load(trace: List[TraceJobSpec], total_gpus: int,
                 duration_s: float) -> float:
    """Average fraction of GPUs serving active jobs (Gavel's load metric)."""
    events = []
    for spec in trace:
        events.append((spec.submit_time_s, spec.n_tasks))
        events.append((spec.submit_time_s + spec.duration_s, -spec.n_tasks))
    events.sort()
    load_time = 0.0
    active = 0
    prev = 0.0
    for t, d in events:
        t = min(t, duration_s)
        load_time += active * (t - prev)
        active += d
        prev = t
        if prev >= duration_s:
            break
    load_time += active * max(0.0, duration_s - prev)
    return load_time / (total_gpus * duration_s)
