"""Full-trace cluster simulation: Metronome vs Default vs Diktyo vs Ideal,
on the PyTorch port (``examples/cluster_sim.py`` with ``repro_torch``).

Reproduces the paper's Fig. 10 experiment shape through the declarative
API: a Gavel-style trace becomes ONE trace-mode Scenario (online arrivals,
queueing, eviction) and the mechanisms are a Policy list — including the
controller ablations that only the new API can apply to trace runs
(``--no-joint`` / ``--no-reconfigure``).

The fluid engine follows ``--device``: on the card (the default) the CUDA
fill kernel, the port's default backend (float32); on the CPU the
``'python'`` backend, the bit-for-bit seed path, so the tables equal the
JAX package's example.

Run:  PYTHONPATH=src python examples_torch/cluster_sim.py [--jobs 10]
      [--seed 1] [--device cpu]
"""
import argparse

import torch

from repro_torch.configs.metronome_testbed import MODEL_FLEET, trace_scenario
from repro_torch.core.cluster import make_fabric_cluster
from repro_torch.core.experiment import Policy, sweep
from repro_torch.core.simulator import SimConfig
from repro_torch.core.trace import cluster_load, generate_trace


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--duration-s", type=float, default=1800.0)
    ap.add_argument("--fabric", type=float, default=None, metavar="RATIO",
                    help="run on a 2-leaf fabric with this oversubscription "
                         "ratio instead of the paper's star testbed")
    ap.add_argument("--no-joint", action="store_true",
                    help="ablate the fabric-wide joint rotation planner "
                         "(legacy uplink-wins tie-break)")
    ap.add_argument("--no-reconfigure", action="store_true",
                    help="ablate the section III-C reconfiguration loop")
    ap.add_argument("--device", default="cuda",
                    help="cuda: the fill kernel; cpu: the python backend")
    args = ap.parse_args(argv)

    backend = ("kernel" if torch.device(args.device).type == "cuda"
               else "python")
    cfg = SimConfig(duration_ms=1_200_000, seed=0, jitter_std=0.01,
                    fluid_backend=backend, device=args.device)
    trace = generate_trace(MODEL_FLEET, duration_s=args.duration_s,
                           total_gpus=13, target_load=0.85, seed=args.seed,
                           job_duration_range_s=(120, 240))[: args.jobs]
    print(f"trace: {len(trace)} jobs, load="
          f"{cluster_load(trace, 13, args.duration_s):.2f}")

    cluster_factory = None
    if args.fabric is not None:
        cluster_factory = lambda: make_fabric_cluster(  # noqa: E731
            n_leaves=2, hosts_per_leaf=2, oversubscription=args.fabric)
    scenario = trace_scenario(trace, open_ended=False,
                              cluster_factory=cluster_factory,
                              name="gavel-trace")
    policies = [
        Policy("metronome", rotation_joint=not args.no_joint,
               reconfigure=not args.no_reconfigure, label="metronome"),
        Policy("default"), Policy("diktyo"), Policy("ideal"),
    ]

    grid = sweep([scenario], policies, cfg)
    print(f"\n{'scheduler':12s} {'TCT (s)':>10s} {'avg BW util':>12s} "
          f"{'readjusts':>10s} {'queued':>7s}")
    for pol in policies:
        r = grid.get(scenario.name, pol.name)
        print(f"{pol.name:12s} {r.sim.total_completion_ms / 1e3:10.1f} "
              f"{r.sim.avg_bw_utilization:12.3f} "
              f"{r.sim.readjustments:10d} {len(r.rejected):7d}")
    me = grid.get(scenario.name, "metronome").sim.total_completion_ms / 1e3
    de = grid.get(scenario.name, "default").sim.total_completion_ms / 1e3
    print(f"\nMetronome finishes {de - me:+.1f}s relative to Default "
          f"({100 * (1 - me / de):.1f}% faster)")
    return grid


if __name__ == "__main__":
    main()
