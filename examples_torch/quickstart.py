"""Quickstart: the declarative Scenario/Policy experiment API, on the
PyTorch port (``examples/quickstart.py`` with ``repro_torch``).

A Scenario says WHAT runs (cluster + workloads + background + events), a
Policy says HOW it is scheduled (mechanism + ablation knobs), and
``run(scenario, policy)`` / ``sweep(scenarios, policies)`` execute the
grid — the shape of the paper's whole evaluation (snapshots x mechanisms).

Shows, in one page: a two-job contention scenario, a policy grid with an
ablation (``rotation_mode='compact'``), the typed per-cell results, the
JSON round-trip that backs the persisted ``BENCH_sweep.json`` artifact,
and the fluid engine's vectorised backend on ``--device``: the CUDA fill
kernel on the card (the default), the plain PyTorch fill on the CPU.  The
grid runs the ``'python'`` fluid backend, the bit-for-bit seed path.

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse
import dataclasses
import json

import torch

from repro_torch.core.cluster import Cluster, Node, Resources
from repro_torch.core.experiment import Policy, Scenario, sweep
from repro_torch.core.results import ExperimentResult
from repro_torch.core.simulator import SimConfig
from repro_torch.core.workload import HIGH, LOW, Workload, make_job


def build():
    """Fresh cluster + workloads per materialization (jobs are mutated by
    scheduling, so every run() cell gets its own copies)."""
    nodes = [Node(f"n{i}", Resources(cpu=32, mem=256, gpu=4), bw_gbps=25.0)
             for i in range(2)]
    cluster = Cluster(nodes)
    hi = make_job("train-hi", n_tasks=2, period_ms=100.0, duty=0.45,
                  bw_gbps=20.0, priority=HIGH, n_iterations=200)
    lo = make_job("train-lo", n_tasks=2, period_ms=100.0, duty=0.45,
                  bw_gbps=20.0, priority=LOW, submit_time_s=0.001,
                  n_iterations=200)
    wls = [Workload(name=j.name, jobs=[j]) for j in (hi, lo)]
    return cluster, wls


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the vectorised fluid backend solves")
    args = ap.parse_args(argv)

    scenario = Scenario(name="two-job-contention", build=build)
    policies = [
        Policy("metronome"),
        Policy("metronome", rotation_mode="compact", label="metronome-compact"),
        Policy("default"),
        Policy("ideal"),  # dedicated-cluster reference (contention-free bound)
    ]
    cfg = SimConfig(duration_ms=40_000.0, seed=0, jitter_std=0.01,
                    fluid_backend="python", device=args.device)
    # the vectorised cell's backend: the kernel on the card, the plain
    # fill on the host (SimConfig raises here when the card is missing)
    vec_backend = ("kernel" if torch.device(args.device).type == "cuda"
                   else "torch")
    vec_cfg = dataclasses.replace(cfg, fluid_backend=vec_backend)

    grid = sweep([scenario], policies, cfg)
    print(f"{'policy':20s} {'hi s/1000':>10s} {'lo s/1000':>10s} "
          f"{'gamma':>7s} {'readj':>6s}")
    for pol in policies:
        r = grid.get(scenario.name, pol.name)
        print(f"{pol.name:20s} {r.mean_s_per_1000(r.high_priority):10.2f} "
              f"{r.mean_s_per_1000(r.low_priority):10.2f} "
              f"{r.sim.avg_bw_utilization:7.3f} {r.sim.readjustments:6d}")

    me = grid.get(scenario.name, "metronome")
    de = grid.get(scenario.name, "default")
    lo_gain = 100.0 * (1 - me.mean_s_per_1000(me.low_priority)
                       / de.mean_s_per_1000(de.low_priority))
    print(f"\nMetronome low-priority acceleration vs Default: "
          f"{lo_gain:.1f}%")

    # results are schema-versioned JSON: what benchmarks persist in CI
    payload = me.to_json_dict(include_durations=False)
    back = ExperimentResult.from_json_dict(json.loads(json.dumps(payload)))
    print(f"JSON round-trip: policy={back.policy!r}, "
          f"placements={back.placements}")

    # sim_backend swaps the simulator's fluid rate engine per cell
    # (DESIGN.md section 16): 'python' is the bit-for-bit seed path;
    # 'torch' / 'kernel' solve the (flows x links) fixed point vectorized
    # in float32 — the same rates to float32 tolerance, and the only way
    # to push 10k-job production traces.  The knob encodes itself in the
    # cell name, so ablation grids stay collision-free.
    vec = Policy("metronome", sim_backend=vec_backend)
    rv = sweep([scenario], [vec], vec_cfg).get(scenario.name, vec.name)
    print(f"{vec.name}: lo s/1000 = "
          f"{rv.mean_s_per_1000(rv.low_priority):.2f} (vs "
          f"{me.mean_s_per_1000(me.low_priority):.2f} under 'python')")
    return grid, rv


if __name__ == "__main__":
    main()
