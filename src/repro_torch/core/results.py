"""Typed, serializable experiment results (DESIGN.md section 14).

The paper's evaluation is a grid — snapshots x scenarios x mechanisms — so
results are grid-shaped too:

  * :class:`ExperimentResult` — one ``run(scenario, policy)`` outcome: the
    simulator measurements plus the admission split and the priority split
    (the latter replaces the benchmarks' old ``"_workloads"`` magic key).
  * :class:`SweepCell` / :class:`SweepResult` — one grid cell / the whole
    grid.  A cell that raised carries ``status="error"`` and the traceback
    instead of poisoning its neighbours (per-cell error isolation).

Everything serializes to schema-versioned JSON (``SCHEMA_VERSION``):
benchmarks write their sweeps as ``BENCH_sweep.json`` (``to_bench_dict``)
and CI validates the artifact with :func:`validate_bench_dict` so
result-format drift fails the build instead of rotting silently.  NaN is
mapped to JSON ``null`` on the way out (strict parsers choke on bare NaN)
and restored on the way back.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from .simulator import SimResult

SCHEMA_VERSION = 1


def _f(v: Optional[float]) -> Optional[float]:
    """float -> JSON-safe float (NaN/inf -> None)."""
    if v is None:
        return None
    v = float(v)
    return None if not math.isfinite(v) else v


def _unf(v: Optional[float]) -> float:
    return math.nan if v is None else float(v)


def _fmap(d: Mapping[str, float]) -> Dict[str, Optional[float]]:
    return {k: _f(v) for k, v in d.items()}


def _unfmap(d: Mapping[str, Optional[float]]) -> Dict[str, float]:
    return {k: _unf(v) for k, v in d.items()}


def sim_to_dict(sim: SimResult, include_durations: bool = True) -> Dict[str, Any]:
    """JSON-safe dict of a :class:`SimResult`.

    ``include_durations=False`` drops the per-iteration duration lists (the
    bulky part) but always keeps the derived per-job mean so compact
    artifacts stay analyzable."""
    d: Dict[str, Any] = {
        "time_per_1000_iters_s": _fmap(sim.time_per_1000_iters_s),
        "link_utilization": _fmap(sim.link_utilization),
        "avg_bw_utilization": _f(sim.avg_bw_utilization),
        "readjustments": int(sim.readjustments),
        "finish_times_ms": _fmap(sim.finish_times_ms),
        "total_completion_ms": _f(sim.total_completion_ms),
        "iterations_done": {k: int(v) for k, v in sim.iterations_done.items()},
        "reconfigurations": int(sim.reconfigurations),
        "suppressed_reconfigurations": int(sim.suppressed_reconfigurations),
        "reconciliations": int(sim.reconciliations),
        "mean_iter_ms": {j: _f(sim.mean_iter_ms(j)) for j in sim.durations_ms},
    }
    if include_durations:
        d["durations_ms"] = {k: [_f(x) for x in v]
                             for k, v in sim.durations_ms.items()}
    return d


def sim_from_dict(d: Mapping[str, Any]) -> SimResult:
    durations = d.get("durations_ms")
    if durations is None:  # compact artifact: jobs known, samples dropped
        durations = {k: [] for k in d.get("iterations_done", {})}
    return SimResult(
        durations_ms={k: [_unf(x) for x in v] for k, v in durations.items()},
        time_per_1000_iters_s=_unfmap(d["time_per_1000_iters_s"]),
        link_utilization=_unfmap(d["link_utilization"]),
        avg_bw_utilization=_unf(d["avg_bw_utilization"]),
        readjustments=int(d["readjustments"]),
        finish_times_ms=_unfmap(d["finish_times_ms"]),
        total_completion_ms=_unf(d["total_completion_ms"]),
        iterations_done={k: int(v) for k, v in d["iterations_done"].items()},
        reconfigurations=int(d.get("reconfigurations", 0)),
        suppressed_reconfigurations=int(
            d.get("suppressed_reconfigurations", 0)),
        reconciliations=int(d.get("reconciliations", 0)),
    )


@dataclasses.dataclass
class ExperimentResult:
    """One ``run(scenario, policy)`` outcome.

    ``high_priority`` / ``low_priority`` name every job of the scenario's
    workloads split by priority (including rejected jobs) — the typed
    replacement for re-deriving the split from a workload list."""

    scenario: str
    policy: str
    scheduler: str
    accepted: List[str]
    rejected: List[str]
    placements: Dict[str, List[str]]
    high_priority: List[str]
    low_priority: List[str]
    sim: SimResult

    # ------------------------------------------------------------ aggregates
    def mean_s_per_1000(self, jobs: Optional[Sequence[str]] = None) -> float:
        """Mean time-per-1000-iterations (s) over ``jobs`` (default: every
        measured job), skipping jobs without samples."""
        if jobs is None:
            jobs = list(self.sim.time_per_1000_iters_s)
        vals = [self.sim.time_per_1000_iters_s[j] for j in jobs
                if j in self.sim.time_per_1000_iters_s
                and not math.isnan(self.sim.time_per_1000_iters_s[j])]
        return float(np.mean(vals)) if vals else math.nan

    def mean_jct_ms(self, jobs: Optional[Sequence[str]] = None) -> float:
        """Mean finish time (ms) over ``jobs`` that finished."""
        if jobs is None:
            jobs = list(self.sim.finish_times_ms)
        vals = [self.sim.finish_times_ms[j] for j in jobs
                if j in self.sim.finish_times_ms
                and not math.isnan(self.sim.finish_times_ms[j])]
        return float(np.mean(vals)) if vals else math.nan

    # ----------------------------------------------------------------- (de)ser
    def to_json_dict(self, include_durations: bool = True) -> Dict[str, Any]:
        return {
            "scenario": self.scenario,
            "policy": self.policy,
            "scheduler": self.scheduler,
            "accepted": list(self.accepted),
            "rejected": list(self.rejected),
            "placements": {k: list(v) for k, v in self.placements.items()},
            "high_priority": list(self.high_priority),
            "low_priority": list(self.low_priority),
            "sim": sim_to_dict(self.sim, include_durations=include_durations),
        }

    @classmethod
    def from_json_dict(cls, d: Mapping[str, Any]) -> "ExperimentResult":
        return cls(
            scenario=d["scenario"],
            policy=d["policy"],
            scheduler=d["scheduler"],
            accepted=list(d["accepted"]),
            rejected=list(d["rejected"]),
            placements={k: list(v) for k, v in d["placements"].items()},
            high_priority=list(d["high_priority"]),
            low_priority=list(d["low_priority"]),
            sim=sim_from_dict(d["sim"]),
        )


@dataclasses.dataclass
class SweepCell:
    """One (scenario, policy) grid cell: a result or an isolated failure."""

    scenario: str
    policy: str
    status: str  # "ok" | "error"
    result: Optional[ExperimentResult] = None
    error: Optional[str] = None  # traceback text when status == "error"

    def to_json_dict(self, include_durations: bool = True) -> Dict[str, Any]:
        d: Dict[str, Any] = {"scenario": self.scenario, "policy": self.policy,
                             "status": self.status}
        if self.result is not None:
            d["result"] = self.result.to_json_dict(
                include_durations=include_durations)
        if self.error is not None:
            d["error"] = self.error
        return d

    @classmethod
    def from_json_dict(cls, d: Mapping[str, Any]) -> "SweepCell":
        res = d.get("result")
        return cls(scenario=d["scenario"], policy=d["policy"],
                   status=d["status"],
                   result=ExperimentResult.from_json_dict(res)
                   if res is not None else None,
                   error=d.get("error"))


@dataclasses.dataclass
class SweepResult:
    """A full scenario x policy grid (row-major over scenarios)."""

    cells: List[SweepCell]
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    schema_version: int = SCHEMA_VERSION

    # ------------------------------------------------------------------ access
    def cell(self, scenario: str, policy: str) -> SweepCell:
        for c in self.cells:
            if c.scenario == scenario and c.policy == policy:
                return c
        raise KeyError(f"no cell ({scenario!r}, {policy!r}); have "
                       f"{[(c.scenario, c.policy) for c in self.cells]}")

    def get(self, scenario: str, policy: str) -> ExperimentResult:
        """The cell's result; raises if the cell failed (use :meth:`cell`
        to inspect the captured traceback instead)."""
        c = self.cell(scenario, policy)
        if c.status != "ok" or c.result is None:
            raise RuntimeError(
                f"cell ({scenario!r}, {policy!r}) failed:\n{c.error}")
        return c.result

    @property
    def errors(self) -> List[SweepCell]:
        return [c for c in self.cells if c.status != "ok"]

    def scenario_results(self, scenario: str) -> Dict[str, ExperimentResult]:
        """policy name -> result for every OK cell of one scenario."""
        return {c.policy: c.result for c in self.cells
                if c.scenario == scenario and c.status == "ok"
                and c.result is not None}

    # ----------------------------------------------------------------- (de)ser
    def to_json_dict(self, include_durations: bool = True) -> Dict[str, Any]:
        return {
            "schema_version": self.schema_version,
            "meta": dict(self.meta),
            "cells": [c.to_json_dict(include_durations=include_durations)
                      for c in self.cells],
        }

    @classmethod
    def from_json_dict(cls, d: Mapping[str, Any]) -> "SweepResult":
        version = int(d.get("schema_version", -1))
        if version != SCHEMA_VERSION:
            raise ValueError(f"sweep schema version {version} != "
                             f"supported {SCHEMA_VERSION}")
        return cls(cells=[SweepCell.from_json_dict(c) for c in d["cells"]],
                   meta=dict(d.get("meta", {})),
                   schema_version=version)

    def save(self, path: str, include_durations: bool = True) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json_dict(include_durations=include_durations),
                      f, indent=1, allow_nan=False)

    @classmethod
    def load(cls, path: str) -> "SweepResult":
        with open(path) as f:
            return cls.from_json_dict(json.load(f))


# --------------------------------------------------------------- BENCH file
def to_bench_dict(sweeps: Sequence[SweepResult], *,
                  smoke: bool = False,
                  include_durations: bool = False) -> Dict[str, Any]:
    """The ``BENCH_sweep.json`` payload: every sweep the bench harness ran,
    compact by default (per-iteration samples dropped, derived means kept)."""
    return {
        "schema_version": SCHEMA_VERSION,
        "generated_by": "benchmarks.run",
        "smoke": bool(smoke),
        "sweeps": [s.to_json_dict(include_durations=include_durations)
                   for s in sweeps],
    }


# ------------------------------------------------------------ timing BENCH
# The second artifact family: benchmark timing rows (``common.emit``'s
# ``name,us_per_call,derived`` contract) persisted as schema-versioned JSON
# (``BENCH_sched_time.json``) so scheduler-latency regressions are a
# machine-readable trajectory instead of stdout-only CSV.

def to_timing_dict(rows: Sequence[Mapping[str, Any]], *,
                   smoke: bool = False) -> Dict[str, Any]:
    """The ``BENCH_sched_time.json`` payload: every ``emit`` row the bench
    harness produced, each ``{name, us_per_call, derived, origin}``."""
    return {
        "schema_version": SCHEMA_VERSION,
        "generated_by": "benchmarks.run",
        "kind": "timing",
        "smoke": bool(smoke),
        "rows": [
            {"name": str(r["name"]),
             "us_per_call": _f(float(r["us_per_call"])),
             "derived": str(r.get("derived", "")),
             "origin": str(r.get("origin", ""))}
            for r in rows
        ],
    }


def validate_timing_dict(doc: Mapping[str, Any]) -> List[str]:
    """Schema check of a timing-rows payload; empty list == valid."""
    problems: List[str] = []
    if not isinstance(doc, Mapping):
        return ["top level is not an object"]
    if doc.get("schema_version") != SCHEMA_VERSION:
        problems.append(f"schema_version {doc.get('schema_version')!r} != "
                        f"{SCHEMA_VERSION}")
    if doc.get("kind") != "timing":
        problems.append(f"kind {doc.get('kind')!r} != 'timing'")
    rows = doc.get("rows")
    if not isinstance(rows, list):
        problems.append("'rows' missing or not a list")
        return problems
    if not rows:
        problems.append("'rows' is empty — no benchmark emitted a timing")
    for ri, row in enumerate(rows):
        where = f"rows[{ri}]"
        if not isinstance(row, Mapping):
            problems.append(f"{where} is not an object")
            continue
        if not isinstance(row.get("name"), str) or not row.get("name"):
            problems.append(f"{where}.name missing or not a string")
        us = row.get("us_per_call")
        if not isinstance(us, (int, float)) or isinstance(us, bool):
            problems.append(f"{where}.us_per_call missing or not a number")
        for key in ("derived", "origin"):
            if not isinstance(row.get(key), str):
                problems.append(f"{where}.{key} missing or not a string")
    return problems


def to_trace_throughput_dict(rows: Sequence[Mapping[str, Any]], *,
                             smoke: bool = False) -> Dict[str, Any]:
    """The ``BENCH_trace_throughput.json`` payload: one row per fluid-rate
    backend timed over the production-trace fill-problem corpus
    (``benchmarks/bench_trace_throughput.py``).  ``speedup_vs_python`` on
    the vectorized rows is the acceptance metric the CI gate reads."""
    return {
        "schema_version": SCHEMA_VERSION,
        "generated_by": "benchmarks.run",
        "kind": "trace_throughput",
        "smoke": bool(smoke),
        "rows": [
            {"name": str(r["name"]),
             "backend": str(r["backend"]),
             "n_jobs": int(r["n_jobs"]),
             "n_problems": int(r["n_problems"]),
             "n_flows": int(r["n_flows"]),
             "seconds": _f(float(r["seconds"])),
             "problems_per_s": _f(float(r["problems_per_s"])),
             "flows_per_s": _f(float(r["flows_per_s"])),
             "speedup_vs_python": _f(float(r["speedup_vs_python"])),
             "max_abs_err_vs_python": _f(float(r["max_abs_err_vs_python"])),
             "origin": str(r.get("origin", ""))}
            for r in rows
        ],
    }


def validate_trace_throughput_dict(doc: Mapping[str, Any]) -> List[str]:
    """Schema check of a trace-throughput payload; empty list == valid."""
    problems: List[str] = []
    if not isinstance(doc, Mapping):
        return ["top level is not an object"]
    if doc.get("schema_version") != SCHEMA_VERSION:
        problems.append(f"schema_version {doc.get('schema_version')!r} != "
                        f"{SCHEMA_VERSION}")
    if doc.get("kind") != "trace_throughput":
        problems.append(f"kind {doc.get('kind')!r} != 'trace_throughput'")
    rows = doc.get("rows")
    if not isinstance(rows, list):
        problems.append("'rows' missing or not a list")
        return problems
    if not rows:
        problems.append("'rows' is empty — no backend was benchmarked")
    backends = set()
    for ri, row in enumerate(rows):
        where = f"rows[{ri}]"
        if not isinstance(row, Mapping):
            problems.append(f"{where} is not an object")
            continue
        for key in ("name", "backend", "origin"):
            if not isinstance(row.get(key), str) or row.get(key) is None:
                problems.append(f"{where}.{key} missing or not a string")
        for key in ("n_jobs", "n_problems", "n_flows"):
            v = row.get(key)
            if not isinstance(v, int) or isinstance(v, bool):
                problems.append(f"{where}.{key} missing or not an int")
        for key in ("seconds", "problems_per_s", "flows_per_s",
                    "speedup_vs_python", "max_abs_err_vs_python"):
            v = row.get(key)
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                problems.append(f"{where}.{key} missing or not a number")
        backends.add(row.get("backend"))
    if rows and "python" not in backends:
        problems.append("no 'python' baseline row — speedups are unanchored")
    return problems


def to_dynamic_throughput_dict(rows: Sequence[Mapping[str, Any]], *,
                               smoke: bool = False) -> Dict[str, Any]:
    """The ``BENCH_dynamic_throughput.json`` payload: one row per
    (event-loop, fluid-backend) combination driving the full dynamic event
    loop over the 10k-job production trace
    (``benchmarks/bench_dynamic_throughput.py``).

    ``speedup_vs_legacy`` on the array rows is the acceptance metric the
    CI gate reads (>= 10x end-to-end on the non-smoke trace);
    ``max_abs_err_vs_oracle`` audits sampled in-loop solves of vectorized
    backends against ``fill_python`` re-solves (0 for the python oracle,
    which is instead bit-for-bit by construction — pinned in
    ``tests/test_event_loop.py``).  ``profile`` carries the per-phase
    counters/timings of ``SimConfig.profile``; ``corpus`` the
    ``fluid.CorpusStats`` bucket occupancy, so batch-padding waste is in
    the artifact rather than silent."""
    out = []
    for r in rows:
        profile = r.get("profile")
        corpus = r.get("corpus")
        out.append(
            {"name": str(r["name"]),
             "loop": str(r["loop"]),
             "backend": str(r["backend"]),
             "n_jobs": int(r["n_jobs"]),
             "n_events": int(r["n_events"]),
             "ticks": int(r["ticks"]),
             "seconds": _f(float(r["seconds"])),
             "speedup_vs_legacy": _f(float(r["speedup_vs_legacy"])),
             "max_abs_err_vs_oracle": _f(float(r["max_abs_err_vs_oracle"])),
             "profile": dict(profile) if profile is not None else None,
             "corpus": dict(corpus) if corpus is not None else None,
             "origin": str(r.get("origin", ""))})
    return {
        "schema_version": SCHEMA_VERSION,
        "generated_by": "benchmarks.run",
        "kind": "dynamic_throughput",
        "smoke": bool(smoke),
        "rows": out,
    }


def validate_dynamic_throughput_dict(doc: Mapping[str, Any]) -> List[str]:
    """Schema check of a dynamic-throughput payload; empty list == valid."""
    problems: List[str] = []
    if not isinstance(doc, Mapping):
        return ["top level is not an object"]
    if doc.get("schema_version") != SCHEMA_VERSION:
        problems.append(f"schema_version {doc.get('schema_version')!r} != "
                        f"{SCHEMA_VERSION}")
    if doc.get("kind") != "dynamic_throughput":
        problems.append(f"kind {doc.get('kind')!r} != 'dynamic_throughput'")
    rows = doc.get("rows")
    if not isinstance(rows, list):
        problems.append("'rows' missing or not a list")
        return problems
    if not rows:
        problems.append("'rows' is empty — no loop/backend was benchmarked")
    loops = set()
    for ri, row in enumerate(rows):
        where = f"rows[{ri}]"
        if not isinstance(row, Mapping):
            problems.append(f"{where} is not an object")
            continue
        for key in ("name", "loop", "backend", "origin"):
            if not isinstance(row.get(key), str):
                problems.append(f"{where}.{key} missing or not a string")
        for key in ("n_jobs", "n_events", "ticks"):
            v = row.get(key)
            if not isinstance(v, int) or isinstance(v, bool):
                problems.append(f"{where}.{key} missing or not an int")
        for key in ("seconds", "speedup_vs_legacy", "max_abs_err_vs_oracle"):
            v = row.get(key)
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                problems.append(f"{where}.{key} missing or not a number")
        for key in ("profile", "corpus"):
            v = row.get(key)
            if v is not None and not isinstance(v, Mapping):
                problems.append(f"{where}.{key} neither null nor an object")
        loops.add(row.get("loop"))
    if rows and "legacy" not in loops:
        problems.append("no 'legacy' baseline row — speedups are unanchored")
    if rows and "array" not in loops:
        problems.append("no 'array' row — the optimized loop was not timed")
    return problems


ROBUSTNESS_AXES = ("noise", "staleness", "failure", "trace")


def to_robustness_dict(rows: Sequence[Mapping[str, Any]], *,
                       smoke: bool = False) -> Dict[str, Any]:
    """The ``BENCH_robustness.json`` payload: graceful-degradation curves
    under an imperfect-information control plane
    (``benchmarks/bench_robustness.py``, DESIGN.md section 19).

    One row per (axis, scenario, policy, x) point, seed-averaged.  ``axis``
    names the swept distortion (``noise`` = telemetry noise_std,
    ``staleness`` = telemetry staleness_ms, ``failure`` = flapping-cycle
    count, ``trace`` = noise_std on an online trace); ``x`` its value.
    ``degradation`` is the job-mean time-per-1000-iterations ratio against
    the same (axis, scenario, policy) group's ``x == 0`` anchor — 1.0 at
    the anchor by construction, and the acceptance criterion is that the
    robust policy's curve stays monotone-ish and SHALLOWER than the
    oracle-assuming ablation's.  The controller diagnostics
    (``readjustments``/``reconfigurations``/``suppressed_reconfigurations``/
    ``reconciliations``) record WHY: suppressed replans and adopted
    reconciliations are the degradation-control machinery firing."""
    out = []
    for r in rows:
        out.append(
            {"axis": str(r["axis"]),
             "scenario": str(r["scenario"]),
             "policy": str(r["policy"]),
             "x": _f(float(r["x"])),
             "seeds": int(r["seeds"]),
             "t1000_mean_s": _f(float(r["t1000_mean_s"])),
             "t1000_hi_s": _f(float(r["t1000_hi_s"])),
             "t1000_lo_s": _f(float(r["t1000_lo_s"])),
             "degradation": _f(float(r["degradation"])),
             "readjustments": _f(float(r["readjustments"])),
             "reconfigurations": _f(float(r["reconfigurations"])),
             "suppressed_reconfigurations": _f(
                 float(r["suppressed_reconfigurations"])),
             "reconciliations": _f(float(r["reconciliations"])),
             "origin": str(r.get("origin", ""))})
    return {
        "schema_version": SCHEMA_VERSION,
        "generated_by": "benchmarks.run",
        "kind": "robustness",
        "smoke": bool(smoke),
        "rows": out,
    }


def validate_robustness_dict(doc: Mapping[str, Any]) -> List[str]:
    """Schema check of a robustness payload; empty list == valid."""
    problems: List[str] = []
    if not isinstance(doc, Mapping):
        return ["top level is not an object"]
    if doc.get("schema_version") != SCHEMA_VERSION:
        problems.append(f"schema_version {doc.get('schema_version')!r} != "
                        f"{SCHEMA_VERSION}")
    if doc.get("kind") != "robustness":
        problems.append(f"kind {doc.get('kind')!r} != 'robustness'")
    rows = doc.get("rows")
    if not isinstance(rows, list):
        problems.append("'rows' missing or not a list")
        return problems
    if not rows:
        problems.append("'rows' is empty — no degradation curve was run")
    policies = set()
    anchors = set()
    groups = set()
    for ri, row in enumerate(rows):
        where = f"rows[{ri}]"
        if not isinstance(row, Mapping):
            problems.append(f"{where} is not an object")
            continue
        for key in ("axis", "scenario", "policy", "origin"):
            if not isinstance(row.get(key), str):
                problems.append(f"{where}.{key} missing or not a string")
        if row.get("axis") not in ROBUSTNESS_AXES:
            problems.append(f"{where}.axis {row.get('axis')!r} not in "
                            f"{ROBUSTNESS_AXES}")
        v = row.get("seeds")
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            problems.append(f"{where}.seeds missing or not a positive int")
        for key in ("x", "t1000_mean_s", "degradation", "readjustments",
                    "reconfigurations", "suppressed_reconfigurations",
                    "reconciliations"):
            v = row.get(key)
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                problems.append(f"{where}.{key} missing or not a number")
        for key in ("t1000_hi_s", "t1000_lo_s"):
            # null (NaN) is legitimate: a scenario may have no jobs of
            # that priority class with measured iterations
            v = row.get(key)
            if v is not None and (not isinstance(v, (int, float))
                                  or isinstance(v, bool)):
                problems.append(f"{where}.{key} not a number or null")
        policies.add(row.get("policy"))
        group = (row.get("axis"), row.get("scenario"), row.get("policy"))
        groups.add(group)
        if row.get("x") == 0.0:
            anchors.add(group)
            deg = row.get("degradation")
            if isinstance(deg, (int, float)) and abs(deg - 1.0) > 1e-9:
                problems.append(
                    f"{where}: x == 0 anchor has degradation {deg!r} != 1.0")
    if rows and len(policies) < 2:
        problems.append("fewer than 2 policies — the degradation curve has "
                        "no ablation to compare against")
    for g in sorted(groups - anchors):
        problems.append(f"group {g} has no x == 0 anchor row — its "
                        "degradation ratios are unanchored")
    return problems


_CELL_RESULT_KEYS = ("scenario", "policy", "scheduler", "accepted",
                     "rejected", "placements", "high_priority",
                     "low_priority", "sim")
_SIM_KEYS = ("time_per_1000_iters_s", "link_utilization",
             "avg_bw_utilization", "readjustments", "finish_times_ms",
             "total_completion_ms", "iterations_done", "reconfigurations",
             "suppressed_reconfigurations", "reconciliations",
             "mean_iter_ms")


def validate_bench_dict(doc: Mapping[str, Any]) -> List[str]:
    """Schema check of a ``BENCH_sweep.json`` payload.

    Returns a list of human-readable problems; empty list == valid.  Used
    by ``scripts/validate_bench.py`` in CI so format drift fails the build."""
    problems: List[str] = []
    if not isinstance(doc, Mapping):
        return ["top level is not an object"]
    if doc.get("schema_version") != SCHEMA_VERSION:
        problems.append(f"schema_version {doc.get('schema_version')!r} != "
                        f"{SCHEMA_VERSION}")
    sweeps = doc.get("sweeps")
    if not isinstance(sweeps, list):
        problems.append("'sweeps' missing or not a list")
        return problems
    if not sweeps:
        problems.append("'sweeps' is empty — no benchmark recorded a sweep")
    for si, sw in enumerate(sweeps):
        where = f"sweeps[{si}]"
        if not isinstance(sw, Mapping):
            problems.append(f"{where} is not an object")
            continue
        if sw.get("schema_version") != SCHEMA_VERSION:
            problems.append(f"{where}.schema_version != {SCHEMA_VERSION}")
        cells = sw.get("cells")
        if not isinstance(cells, list) or not cells:
            problems.append(f"{where}.cells missing or empty")
            continue
        for ci, cell in enumerate(cells):
            cw = f"{where}.cells[{ci}]"
            if not isinstance(cell, Mapping):
                problems.append(f"{cw} is not an object")
                continue
            for key in ("scenario", "policy", "status"):
                if not isinstance(cell.get(key), str):
                    problems.append(f"{cw}.{key} missing or not a string")
            status = cell.get("status")
            if status == "ok":
                res = cell.get("result")
                if not isinstance(res, Mapping):
                    problems.append(f"{cw}.result missing on an ok cell")
                    continue
                for key in _CELL_RESULT_KEYS:
                    if key not in res:
                        problems.append(f"{cw}.result.{key} missing")
                sim = res.get("sim")
                if isinstance(sim, Mapping):
                    for key in _SIM_KEYS:
                        if key not in sim:
                            problems.append(f"{cw}.result.sim.{key} missing")
                else:
                    problems.append(f"{cw}.result.sim missing")
            elif status == "error":
                if not isinstance(cell.get("error"), str):
                    problems.append(f"{cw}.error missing on an error cell")
            else:
                problems.append(f"{cw}.status {status!r} not ok|error")
    return problems
