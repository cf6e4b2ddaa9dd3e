"""The paper's testbed fleet and snapshots (sections IV-A, Table III/IV).

Traffic parameters (period / duty / bandwidth) are calibrated against the
paper's own measurements where the text pins them down:

  * Table VI gives Metronome's (near-ideal) time per 1,000 iterations per
    snapshot: S1 ~ 422 s, S2 ~ 88/99 s, S3 ~ 124/103 s, S4 ~ 533 s,
    S5 ~ 112/430 s  -> ideal iteration times in ms below.
  * section IV-D: in S3, after period doubling of VGG19, WideResNet101 is
    35 ms shorter; G_T = 5 ms, E_T = 10 %.
  * snapshot 0 (GPT-2 + GoogLeNet) is INCOMPATIBLE: the summed communication
    phases exceed the LCM period.

Where the paper gives no number we use plausible values for A30-class DP/MP
training on 25 GbE (duty cycles 0.2-0.6, bandwidth demand 8-24 Gbps).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from ..core.cluster import Cluster, make_fabric_cluster, make_testbed_cluster
from ..core.events import (BackgroundFlowChange, Event,
                          LinkCapacityChange, flapping_schedule)
from ..core.experiment import Scenario
from ..core.simulator import BackgroundFlow, SimConfig
from ..core.topology import uplink_id
from ..core.trace import (TraceJobSpec, trace_departure_events,
                         trace_to_jobs)
from ..core.workload import HIGH, LOW, Job, Workload, make_job

# model -> traffic; period_ms = ideal iteration time (contention free)
MODEL_FLEET: Dict[str, dict] = {
    "VGG11":          dict(period_ms=80.0,  duty=0.40, bw_gbps=20.0, n_tasks=2),
    # FT-VGG16 period chosen so S2 exercises the E_T idle-injection path:
    # 96 - 90 = 6 ms mismatch (> G_T = 5, <= E_T = 10% of 90) -> inject 6 ms
    "FT-VGG16":       dict(period_ms=90.0,  duty=0.48, bw_gbps=25.0, n_tasks=2),
    "FT-VGG19":       dict(period_ms=96.0,  duty=0.48, bw_gbps=25.0, n_tasks=2),
    "FT-VGG19-S3":    dict(period_ms=245.0, duty=0.30, bw_gbps=22.0, n_tasks=2),
    "Pre-VGG19":      dict(period_ms=418.0, duty=0.30, bw_gbps=22.0, n_tasks=2),
    "ResNet18":       dict(period_ms=60.0,  duty=0.25, bw_gbps=12.0, n_tasks=2),
    "ResNet50":       dict(period_ms=120.0, duty=0.30, bw_gbps=15.0, n_tasks=2),
    "FT-ResNet152":   dict(period_ms=110.0, duty=0.25, bw_gbps=18.0, n_tasks=2),
    "FT-WideResNet101": dict(period_ms=120.0, duty=0.35, bw_gbps=20.0, n_tasks=2),
    "GoogLeNet":      dict(period_ms=70.0,  duty=0.20, bw_gbps=8.0,  n_tasks=2),
    "GoogLeNet-S0":   dict(period_ms=70.0,  duty=0.60, bw_gbps=10.0, n_tasks=2),
    "DenseNet201":    dict(period_ms=160.0, duty=0.25, bw_gbps=12.0, n_tasks=2),
    "AlexNet":        dict(period_ms=45.0,  duty=0.50, bw_gbps=24.0, n_tasks=2),
    "GPT-1":          dict(period_ms=424.0, duty=0.17, bw_gbps=20.0, n_tasks=2),
    "GPT-2":          dict(period_ms=600.0, duty=0.50, bw_gbps=22.0, n_tasks=2),
    # BERT's per-pod demand (10G) fits one 25G link twice -> the S4 pair is
    # "strongly compatible" (paper IV-C); congestion avoidance is the gain.
    "BERT":           dict(period_ms=527.0, duty=0.40, bw_gbps=10.0, n_tasks=2),
}

# 13 "real" models of Table III (the -S0/-S3 variants are batch variants)
TABLE_III_MODELS: List[str] = [
    "VGG11", "FT-VGG16", "FT-VGG19", "ResNet18", "ResNet50", "FT-ResNet152",
    "FT-WideResNet101", "GoogLeNet", "DenseNet201", "AlexNet",
    "GPT-1", "GPT-2", "BERT",
]


def _wl(name: str, jobs: List[Job]) -> Workload:
    for j in jobs:
        j.workload = name
        for t in j.tasks:
            t.workload = name
    return Workload(name=name, jobs=jobs)


def make_snapshot(sid: str, n_iterations: int = 400
                  ) -> Tuple[Cluster, List[Workload], List[BackgroundFlow]]:
    """Snapshot compositions of Table IV.  '*' jobs are high priority;
    otherwise earlier-deployed jobs are higher priority (paper note)."""
    cluster = make_testbed_cluster()
    bg: List[BackgroundFlow] = []

    def job(name, model, prio, submit=0.0):
        f = MODEL_FLEET[model]
        return make_job(name, n_tasks=f["n_tasks"], period_ms=f["period_ms"],
                        duty=f["duty"], bw_gbps=f["bw_gbps"], priority=prio,
                        n_iterations=n_iterations, submit_time_s=submit,
                        model=model)

    if sid == "S0":  # incompatible pair (section IV-B1, last paragraph)
        wls = [
            _wl("wl-gpt2", [job("gpt2-0", "GPT-2", HIGH)]),
            _wl("wl-googlenet", [job("googlenet-0", "GoogLeNet-S0", LOW, 0.001)]),
        ]
    elif sid == "S1":  # DP HPO training job x3 (same workload)
        wls = [_wl("wl-hpo-vgg19", [
            job("vgg19-hpo-0", "Pre-VGG19", HIGH),
            job("vgg19-hpo-1", "Pre-VGG19", LOW, 0.001),
            job("vgg19-hpo-2", "Pre-VGG19", LOW, 0.002),
        ])]
    elif sid == "S2":  # FT-VGG16 + FT-VGG19*
        wls = [
            _wl("wl-vgg19", [job("vgg19-ft", "FT-VGG19", HIGH)]),
            _wl("wl-vgg16", [job("vgg16-ft", "FT-VGG16", LOW, 0.001)]),
        ]
    elif sid == "S3":  # FT-WideResNet101 + FT-VGG19*, 2:1 period ratio
        wls = [
            _wl("wl-vgg19s3", [job("vgg19-ft", "FT-VGG19-S3", HIGH)]),
            _wl("wl-wrn", [job("wrn101-ft", "FT-WideResNet101", LOW, 0.001)]),
        ]
    elif sid == "S4":  # Pre-BERT x2 with a congested link
        wls = [_wl("wl-hpo-bert", [
            job("bert-0", "BERT", HIGH),
            job("bert-1", "BERT", LOW, 0.001),
        ])]
        _congest(cluster, bg, "worker-a30-2", iperf_gbps=16.0, tau_ms=40.0)
    elif sid == "S5":  # FT-ResNet152 + Pre-GPT-1*, congested link, DP + MP
        wls = [
            _wl("wl-gpt1", [job("gpt1-pre", "GPT-1", HIGH)]),
            _wl("wl-rn152", [job("rn152-ft", "FT-ResNet152", LOW, 0.001)]),
        ]
        _congest(cluster, bg, "worker-a30-2", iperf_gbps=16.0, tau_ms=40.0)
    elif sid in ("F2", "F4", "J1"):
        return make_fabric_snapshot(sid, n_iterations=n_iterations)
    else:
        raise ValueError(f"unknown snapshot {sid!r}")
    return cluster, wls, bg


def make_fabric_snapshot(sid: str, n_iterations: int = 400
                         ) -> Tuple[Cluster, List[Workload], List[BackgroundFlow]]:
    """Beyond-paper fabric snapshots on an oversubscribed leaf–spine fabric.

    These scenarios are invisible to the seed's host-link-only model: host
    links stay under capacity while the spine uplinks contend, so the only
    scheduler that separates the jobs in time is the one that models the
    uplink (Metronome post-fabric-refactor).

      F2: 2 leaves x 2 hosts @25G, 2:1 oversubscription (25G uplinks).
          Two 4-task jobs span both leaves; per-host demand 12+12 = 24G
          < 25G (no host contention) but each job pushes 24G through each
          uplink -> 48G >> 25G when overlapped.
      F4: 2 leaves x 4 hosts @25G, 4:1 oversubscription (25G uplinks).
          Three 8-task jobs (1 HIGH + 2 LOW) span both leaves; per-host
          demand 3x6 = 18G < 25G, per-uplink 3x24G vs 25G.
      J1: 2 leaves x 2 hosts @25G, 4:1 oversubscription (12.5G uplinks) —
          the joint-rotation oracle snapshot: per-link rotation solves
          PROVABLY conflict.  Two 4-task spanning jobs (hi*/lo, 5G each)
          contend only on the uplinks (in-leaf 10G vs 12.5G; pair 20G);
          an intra-leaf 2-task job (24G, pinned to one rack because 24G
          exceeds the uplink's 12.5G — Eq. 14) contends with both on the
          leaf0 host links (24+5 > 25G).  The host-link solve puts hi/lo
          adjacent (their pair fits a host link, so only the intra-leaf
          job needs separating) while the uplink solve must spread hi/lo
          apart — the host-optimal relative shift is infeasible on the
          shared uplink.  The legacy "uplinks win" reconciliation then
          lands the intra-leaf job on top of the spanning LOW job
          (29G > 25G sustained); the joint planner picks the one region
          where all three constraints hold (bench_rotation.py,
          tests/test_rotation.py).
    """
    def job(name, prio, submit, *, n_tasks, period_ms, duty, bw_gbps):
        return make_job(name, n_tasks=n_tasks, period_ms=period_ms, duty=duty,
                        bw_gbps=bw_gbps, priority=prio,
                        n_iterations=n_iterations, submit_time_s=submit)

    bg: List[BackgroundFlow] = []
    if sid == "F2":
        cluster = make_fabric_cluster(n_leaves=2, hosts_per_leaf=2,
                                      bw_gbps=25.0, oversubscription=2.0)
        spec = dict(n_tasks=4, period_ms=100.0, duty=0.35, bw_gbps=12.0)
        wls = [
            _wl("wl-f2-hi", [job("f2-hi", HIGH, 0.0, **spec)]),
            _wl("wl-f2-lo", [job("f2-lo", LOW, 0.001, **spec)]),
        ]
    elif sid == "F4":
        cluster = make_fabric_cluster(n_leaves=2, hosts_per_leaf=4,
                                      bw_gbps=25.0, oversubscription=4.0)
        spec = dict(n_tasks=8, period_ms=120.0, duty=0.30, bw_gbps=6.0)
        wls = [
            _wl("wl-f4-hi", [job("f4-hi", HIGH, 0.0, **spec)]),
            _wl("wl-f4-lo0", [job("f4-lo0", LOW, 0.001, **spec)]),
            _wl("wl-f4-lo1", [job("f4-lo1", LOW, 0.002, **spec)]),
        ]
    elif sid == "J1":
        cluster = make_fabric_cluster(n_leaves=2, hosts_per_leaf=2,
                                      bw_gbps=25.0, oversubscription=4.0)
        span = dict(n_tasks=4, period_ms=100.0, duty=0.30, bw_gbps=5.0)
        wls = [
            _wl("wl-j1-hi", [job("j1-hi", HIGH, 0.0, **span)]),
            _wl("wl-j1-lo", [job("j1-lo", LOW, 0.001, **span)]),
            _wl("wl-j1-local", [job("j1-local", LOW, 0.002, n_tasks=2,
                                    period_ms=100.0, duty=0.35,
                                    bw_gbps=24.0)]),
        ]
    else:
        raise ValueError(f"unknown fabric snapshot {sid!r}")
    return cluster, wls, bg


def _congest(cluster: Cluster, bg: List[BackgroundFlow], node: str,
             iperf_gbps: float, tau_ms: float) -> None:
    """iPerf3-style congestion (section IV-A 'Traces'): an unregulated flow
    occupies the node's host link; the cluster manager lowers the node's
    ALLOCATABLE bandwidth accordingly (NodeBandwidth CR, section III-A) and
    the latency monitor reports a high tau to that node."""
    bg.append(BackgroundFlow(node=node, rate_gbps=iperf_gbps))
    n = cluster.node(node)
    n.allocatable_gbps = max(0.0, n.bw_gbps - iperf_gbps)
    for other in cluster.node_names:
        if other != node:
            cluster.set_latency(node, other, tau_ms)


def make_dynamic_snapshot(
    sid: str, n_iterations: int = 400, amplitude: float = 0.3,
    t_on_ms: float = 15_000.0, t_off_ms: float = 45_000.0,
) -> Tuple[Cluster, List[Workload], List[BackgroundFlow], List[Event]]:
    """Beyond-paper dynamic snapshots: a static snapshot plus a mid-run
    environment fluctuation (returns an extra event list for the
    simulator's ``events=`` stream — see ``core/events.py``).

      D1 (bandwidth fluctuation): the S2 pair (FT-VGG19* + FT-VGG16) with an
         iPerf3-style background flow ramping on ``worker-a30-0`` — a host
         link every scheduler co-locates both jobs on — between ``t_on`` and
         ``t_off``.  Rate = ``amplitude`` x the 25G link.  The NodeBandwidth
         CR lowers the allocatable share while the flow runs, so the
         controller's reconfiguration loop re-derives the rotation and
         re-baselines the monitor.

      D2 (fabric): the F4 trio (1 HIGH + 2 LOW spanning two leaves at 4:1
         oversubscription) with both spine uplinks dropping to
         ``(1 - amplitude)`` of their capacity (allocatable AND physical —
         a degraded/partitioned spine) between ``t_on`` and ``t_off``,
         forcing uplink-scheme reconfiguration.
    """
    if sid == "D1":
        cluster, wls, bg = make_snapshot("S2", n_iterations=n_iterations)
        link = "worker-a30-0"
        rate = amplitude * cluster.node(link).bw_gbps
        events: List[Event] = [
            BackgroundFlowChange(t_on_ms, link=link, rate_gbps=rate),
            BackgroundFlowChange(t_off_ms, link=link, rate_gbps=0.0),
        ]
    elif sid == "D2":
        cluster, wls, bg = make_snapshot("F4", n_iterations=n_iterations)
        events = []
        for leaf in cluster.topology.uplinks:
            cap = cluster.topology.uplinks[leaf].capacity_gbps
            low = (1.0 - amplitude) * cap
            events.append(LinkCapacityChange(
                t_on_ms, link=uplink_id(leaf),
                allocatable_gbps=low, capacity_gbps=low))
            events.append(LinkCapacityChange(
                t_off_ms, link=uplink_id(leaf),
                allocatable_gbps=cap, capacity_gbps=cap))
    else:
        raise ValueError(f"unknown dynamic snapshot {sid!r}")
    return cluster, wls, bg, events


def make_fault_snapshot(
    sid: str, n_iterations: int = 400, start_ms: float = 15_000.0,
    period_ms: float = 20_000.0, down_ms: float = 2_000.0, n_cycles: int = 3,
) -> Tuple[Cluster, List[Workload], List[BackgroundFlow], List[Event]]:
    """Fault-injection snapshots (DESIGN.md section 19): a static snapshot
    plus an alternating failure/recovery train (:func:`flapping_schedule`).

      R1 (flapping uplink): the F4 trio with spine uplink ``uplink:leaf0``
         failing outright (capacity AND allocatable -> 0) ``n_cycles``
         times for ``down_ms`` each, one failure every ``period_ms``.
         Cross-leaf flows stall on the dead uplink until recovery; the
         controller must re-derive uplink schemes on every transition
         (or, with hysteresis, sit the flap out).

      R2 (flapping host): the S2 pair with ``worker-a30-1`` dying on the
         same schedule — every job with a task on it stalls (flows
         dropped, iteration abandoned) and restarts on recovery.
    """
    if sid == "R1":
        cluster, wls, bg = make_snapshot("F4", n_iterations=n_iterations)
        events = flapping_schedule(
            uplink_id("leaf0"), start_ms=start_ms, period_ms=period_ms,
            down_ms=down_ms, n_cycles=n_cycles)
    elif sid == "R2":
        cluster, wls, bg = make_snapshot("S2", n_iterations=n_iterations)
        events = flapping_schedule(
            "worker-a30-1", start_ms=start_ms, period_ms=period_ms,
            down_ms=down_ms, n_cycles=n_cycles, host=True)
    else:
        raise ValueError(f"unknown fault snapshot {sid!r}")
    return cluster, wls, bg, events


# -------------------------------------------------- declarative scenarios
# (Scenario/Policy experiment API, DESIGN.md section 14): the snapshot
# builders above stay the single source of truth for compositions; these
# wrap them as Scenario instances whose build() returns FRESH objects per
# materialization — exactly what the benchmarks' per-scheduler regeneration
# loop used to do by hand.

# The build callables are module-level dataclass instances, not closures:
# process-mode sweeps (``experiment.sweep(mode='process')``) pickle each
# cell's Scenario into spawned workers, and a closure cannot cross that
# boundary.  ``__call__`` keeps them drop-in where a plain function went.

@dataclasses.dataclass(frozen=True)
class SnapshotBuild:
    """Picklable ``Scenario.build`` of one Table IV / fabric snapshot."""

    sid: str
    n_iterations: int = 400

    def __call__(self):
        cluster, wls, bg = make_snapshot(self.sid,
                                         n_iterations=self.n_iterations)
        return cluster, wls, bg


@dataclasses.dataclass(frozen=True)
class DynamicBuild:
    """Picklable ``Scenario.build`` of one dynamic snapshot (D1/D2)."""

    sid: str
    n_iterations: int = 400
    amplitude: float = 0.3
    t_on_ms: float = 15_000.0
    t_off_ms: float = 45_000.0

    def __call__(self):
        return make_dynamic_snapshot(
            self.sid, n_iterations=self.n_iterations,
            amplitude=self.amplitude, t_on_ms=self.t_on_ms,
            t_off_ms=self.t_off_ms)


@dataclasses.dataclass(frozen=True)
class FaultBuild:
    """Picklable ``Scenario.build`` of one fault snapshot (R1/R2)."""

    sid: str
    n_iterations: int = 400
    start_ms: float = 15_000.0
    period_ms: float = 20_000.0
    down_ms: float = 2_000.0
    n_cycles: int = 3

    def __call__(self):
        return make_fault_snapshot(
            self.sid, n_iterations=self.n_iterations,
            start_ms=self.start_ms, period_ms=self.period_ms,
            down_ms=self.down_ms, n_cycles=self.n_cycles)


@dataclasses.dataclass(frozen=True)
class TraceBuild:
    """Picklable ``Scenario.build`` of a Gavel-style trace scenario.

    ``cluster_factory=None`` means the testbed cluster; a non-None factory
    must itself be picklable (a module-level function or dataclass) for
    process-mode sweeps."""

    trace: Tuple[TraceJobSpec, ...]
    time_scale: float = 1.0
    open_ended: bool = True
    cluster_factory: Optional[Callable[[], Cluster]] = None

    def __call__(self):
        cluster = (self.cluster_factory()
                   if self.cluster_factory is not None
                   else make_testbed_cluster())
        jobs = trace_to_jobs(list(self.trace), MODEL_FLEET,
                             time_scale=self.time_scale,
                             open_ended=self.open_ended)
        wls = []
        for j in jobs:
            wl = Workload(name=j.name, jobs=[j])
            j.workload = wl.name
            for t in j.tasks:
                t.workload = wl.name
            wls.append(wl)
        events = (trace_departure_events(list(self.trace),
                                         time_scale=self.time_scale)
                  if self.open_ended else ())
        return cluster, wls, (), events


def snapshot_scenario(sid: str, n_iterations: int = 400,
                      sim_config: Optional[SimConfig] = None) -> Scenario:
    """The Table IV snapshot (or fabric/joint snapshot) ``sid`` as an
    offline Scenario."""
    return Scenario(name=sid, build=SnapshotBuild(sid, n_iterations),
                    sim_config=sim_config)


def dynamic_scenario(sid: str, n_iterations: int = 400,
                     amplitude: float = 0.3, t_on_ms: float = 15_000.0,
                     t_off_ms: float = 45_000.0,
                     sim_config: Optional[SimConfig] = None) -> Scenario:
    """Dynamic snapshot ``sid`` (D1/D2) with its fluctuation event stream as
    an offline Scenario (the events fire mid-run on the simulator clock)."""
    return Scenario(
        name=sid,
        build=DynamicBuild(sid, n_iterations, amplitude, t_on_ms, t_off_ms),
        sim_config=sim_config)


def fault_scenario(sid: str, n_iterations: int = 400,
                   start_ms: float = 15_000.0, period_ms: float = 20_000.0,
                   down_ms: float = 2_000.0, n_cycles: int = 3,
                   sim_config: Optional[SimConfig] = None) -> Scenario:
    """Fault snapshot ``sid`` (R1/R2) with its failure/recovery train as an
    offline Scenario (events fire mid-run on the simulator clock)."""
    return Scenario(
        name=sid,
        build=FaultBuild(sid, n_iterations, start_ms, period_ms, down_ms,
                         n_cycles),
        sim_config=sim_config)


def trace_scenario(trace: List[TraceJobSpec], *, time_scale: float = 1.0,
                   open_ended: bool = True,
                   cluster_factory: Optional[Callable[[], Cluster]] = None,
                   name: str = "trace",
                   sim_config: Optional[SimConfig] = None) -> Scenario:
    """A Gavel-style trace as a trace-mode Scenario (online arrivals,
    queueing, eviction — the paper's Fig. 10 K8s behavior).

    ``open_ended=True`` truncates jobs by :class:`JobDeparture` events
    instead of an iteration cap (a contended job does FEWER iterations in
    its window; never-admitted jobs depart from the pending queue).  Use
    ``open_ended=False`` for the 'ideal' reference, which ignores the event
    stream and needs the static iteration caps."""
    return Scenario.trace(
        name=name,
        build=TraceBuild(tuple(trace), time_scale=time_scale,
                         open_ended=open_ended,
                         cluster_factory=cluster_factory),
        sim_config=sim_config)


SNAPSHOTS = ("S1", "S2", "S3", "S4", "S5")
# beyond-paper leaf–spine snapshots (oversubscribed fabric; bench_fabric.py)
FABRIC_SNAPSHOTS = ("F2", "F4")
# joint-rotation oracle snapshot (per-link solves conflict; bench_rotation.py)
JOINT_SNAPSHOTS = ("J1",)
# beyond-paper dynamic snapshots (mid-run fluctuation; bench_dynamic.py)
DYNAMIC_SNAPSHOTS = ("D1", "D2")
# fault-injection snapshots (failure/recovery trains; bench_robustness.py)
FAULT_SNAPSHOTS = ("R1", "R2")
