"""One run of one cell, from its files to the result's last line.

``execute`` runs the cell on the device it is given and builds the
result; it does not look for a chip (``run.py`` does, before calling
it).  The cell's traffic names the module that runs it
(``<kind>_cell.py``); its end-to-end metrics come from that module, and
its per-layer metrics from each metric's reader over the traced run's
record.
"""
from __future__ import annotations

import importlib
import math
import sys
from pathlib import Path
from typing import Dict, List

import torch

from . import spec

BREAKDOWN_ENTRIES = 10


def log(line: str) -> None:
    print(f"perfbench: {line}", file=sys.stderr, flush=True)


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def execute(cell: dict, seed: int, seconds: float, trace: bool,
            device: torch.device, t_start: float, scratch: str,
            root: Path = spec.ROOT) -> dict:
    """Run ``cell`` once and return the result line's object, its
    comparison last."""
    runner = importlib.import_module(
        f"perfbench.{cell['traffic']['kind']}_cell")
    res = runner.run(cell, seed, seconds, trace, device, t_start, log,
                     scratch)
    metrics: Dict[str, dict] = {}
    if trace:
        for m in cell["per_layer"]:
            value = spec.metric_reader(m["name"], root)(res["record"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": res["end_to_end"][m["name"]],
                                  "unit": m["unit"]}
    on_gpu = device.type == "cuda"
    out = {
        "correct": bool(res["correct"]),
        "attempted": res["attempted"], "failed": res["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_gpu else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_gpu else "cpu",
            "count": 1, "memory_peak_bytes": res["memory_peak_bytes"]},
    }
    if trace:
        tr = res["record"]["trace"]
        out["device"].update(busy_s=tr["busy_s"], window_s=tr["wall_s"])
        top = sorted(tr["kernels_s"].items(), key=lambda kv: -kv[1])
        out["breakdown"] = {
            "device_ops": [list(kv) for kv in top[:BREAKDOWN_ENTRIES]],
            "idle_gaps": tr["idle_gaps"][:BREAKDOWN_ENTRIES]}
    out["compare"] = {k: {"value": _finite(row["value"]),
                          "limit": row["limit"]}
                      for k, row in res["compare"].items()}
    return out


def compare_lines(result: dict) -> List[str]:
    """The comparison as the last lines of standard error: each number
    beside its limit."""
    return [f"compare {k} {row['value']} limit {row['limit']}"
            for k, row in result["compare"].items()]
