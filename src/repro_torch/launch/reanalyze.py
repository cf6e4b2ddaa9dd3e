"""Re-run the roofline analysis over dumped op traces (no re-tracing; the
JAX package's ``launch/reanalyze.py`` re-reads HLO).

PYTHONPATH=src python -m repro_torch.launch.reanalyze --trace results/trace \\
    --out results/dryrun.json
"""
from __future__ import annotations

import argparse
import glob
import gzip
import json
import os

from .. import configs as config_registry
from ..models.config import SHAPES
from . import cost_analysis
from .dryrun import _fill_roofline


def _mesh_shape(info) -> dict:
    names = (("pod", "data", "model") if info["mesh"].count("x") == 2
             else ("data", "model"))
    return dict(zip(names, (int(n) for n in info["mesh"].split("x"))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default="results/trace")
    ap.add_argument("--out", default="results/dryrun.json")
    args = ap.parse_args()

    with open(args.out) as f:
        results = json.load(f)
    for path in sorted(glob.glob(os.path.join(args.trace, "*.json.gz"))):
        cell_id = os.path.basename(path)[:-len(".json.gz")]
        parts = cell_id.split("__")
        arch, shape, mesh = parts[:3]
        key = "|".join([arch, shape, mesh] + parts[3:])
        if key not in results or results[key].get("status") != "ok":
            continue
        with gzip.open(path, "rt") as f:
            trace = json.load(f)
        info = results[key]
        try:
            cfg = config_registry.get_config(arch)
        except KeyError:
            continue
        _fill_roofline(info, cost_analysis.analyze(trace), cfg,
                       SHAPES[shape], _mesh_shape(info))
        r = info["roofline"]
        print(f"{key}: comp={r['compute_s']:.4f} mem={r['memory_s']:.4f} "
              f"coll={r['collective_s']:.4f} -> {info['bottleneck']}")
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
