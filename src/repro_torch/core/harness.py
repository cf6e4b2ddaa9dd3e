"""Legacy glue API: thin shims over the Scenario/Policy experiment layer.

``run_experiment`` / ``run_trace_experiment`` predate ``core/experiment.py``
and are kept as bit-for-bit-pinned compatibility wrappers (golden
equivalence suite in ``tests/test_experiment.py``): each translates its
kwargs into a :class:`~repro_torch.core.experiment.Scenario` +
:class:`~repro_torch.core.experiment.Policy` pair and delegates to
:func:`~repro_torch.core.experiment.run`.  New code should construct scenarios
and policies directly — every knob that used to be a ``run_experiment``
kwarg is a Policy field, and trace runs accept the full Policy too (the
legacy trace path could not ablate anything).

The port's copy of the JAX package's module: the fluid engine's device
comes with ``config`` (``SimConfig.device``, ``"cuda"`` unless the caller
asks for the CPU, as every entry point of the port).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .controller import StopAndWaitController
from .events import normalize_events
from .experiment import OFFLINE, TRACE, Policy, Scenario, build_scheduler, run
from .cluster import Cluster
from .framework import SchedulerPlugin
from .simulator import BackgroundFlow, SimConfig, SimResult
from .workload import Workload

SCHEDULERS = ("metronome", "default", "diktyo", "exclusive", "ideal")


@dataclasses.dataclass
class RunResult:
    """Legacy result shape (prefer
    :class:`~repro_torch.core.results.ExperimentResult` from the new API)."""

    sim: SimResult
    accepted: List[str]
    rejected: List[str]
    scheduler: str
    placements: Dict[str, List[str]]


def make_plugin(name: str, controller: Optional[StopAndWaitController] = None,
                rotation_mode: str = "intermediate",
                rotation_joint: bool = True) -> SchedulerPlugin:
    """Legacy plugin factory (the registry path builds plugin + controller
    together; this keeps the old build-around-an-existing-controller shape
    for callers that drive the framework by hand)."""
    if name == "metronome":
        from .scheduler import MetronomePlugin
        return MetronomePlugin(controller=controller,
                               rotation_mode=rotation_mode,
                               joint=rotation_joint)
    plugin, _ = build_scheduler(Policy(scheduler=name))
    return plugin


def _legacy_shim(
    mode: str,
    cluster: Cluster,
    workloads: Sequence[Workload],
    config: Optional[SimConfig],
    background: Sequence[BackgroundFlow],
    events: Sequence,
    traffic_changes: Sequence[Tuple[float, str, float]],
    policy: Policy,
) -> RunResult:
    stream = normalize_events(events, traffic_changes)
    scenario = Scenario(name="legacy", mode=mode,
                        build=lambda: (cluster, workloads, background, stream))
    res = run(scenario, policy, config or SimConfig())
    return RunResult(res.sim, res.accepted, res.rejected, res.scheduler,
                     res.placements)


def run_experiment(
    scheduler: str,
    cluster: Cluster,
    workloads: Sequence[Workload],
    config: Optional[SimConfig] = None,
    background: Sequence[BackgroundFlow] = (),
    traffic_changes: Sequence[Tuple[float, str, float]] = (),
    skip_third_stage: bool = False,
    rotation_mode: str = "intermediate",
    events: Sequence = (),
    reconfigure: bool = True,
    rotation_joint: bool = True,
) -> RunResult:
    """Schedule all workloads with the named mechanism, then simulate.

    Legacy shim over ``experiment.run`` — the kwargs map 1:1 onto
    :class:`Policy` fields; legacy ``traffic_changes`` tuples are
    normalized into the typed event stream at this boundary.
    ``scheduler == 'ideal'`` runs every job alone on a pristine copy of the
    cluster (dedicated-cluster reference of the paper) and deliberately
    ignores ``events``/``background``/``traffic_changes``: it is the STATIC
    contention-free bound.
    """
    policy = Policy(scheduler=scheduler, rotation_mode=rotation_mode,
                    rotation_joint=rotation_joint, reconfigure=reconfigure,
                    skip_third_stage=skip_third_stage)
    return _legacy_shim(OFFLINE, cluster, workloads, config,
                        background, events, traffic_changes, policy)


def run_trace_experiment(
    scheduler: str,
    cluster: Cluster,
    workloads: Sequence[Workload],
    config: Optional[SimConfig] = None,
    events: Sequence = (),
    *,
    rotation_mode: str = "intermediate",
    reconfigure: bool = True,
    rotation_joint: bool = True,
) -> RunResult:
    """Online (trace) mode: workloads arrive at their submit times, queue
    when the cluster is full, and release capacity on completion — the K8s
    behavior of the paper's 4 h trace (Fig. 10).

    Legacy shim over ``experiment.run`` with a trace-mode scenario.  The
    controller knobs (``reconfigure``/``rotation_joint``/``rotation_mode``)
    now reach trace runs too — the pre-experiment-API version hardcoded a
    default ``StopAndWaitController`` and silently dropped every ablation.
    ``events`` feeds the simulator's dynamic stream; the trace generator's
    event-driven truncation plugs in here (``trace_to_jobs(...,
    open_ended=True)`` + ``trace_departure_events``)."""
    policy = Policy(scheduler=scheduler, rotation_mode=rotation_mode,
                    rotation_joint=rotation_joint, reconfigure=reconfigure)
    return _legacy_shim(TRACE, cluster, workloads, config,
                        (), events, (), policy)


def priority_split(workloads: Sequence[Workload]) -> Tuple[List[str], List[str]]:
    """Names of (high, low) priority jobs.  The new API carries this split
    on :class:`~repro_torch.core.results.ExperimentResult` directly."""
    hi, lo = [], []
    for wl in workloads:
        for j in wl.jobs:
            (hi if j.priority else lo).append(j.name)
    return hi, lo
