"""Finding a cell's files by the names ``BENCHMARK.json`` gives.

A cell (``workloads`` entry) names its configuration, whose ``file``
holds the model under ``model``; its traffic mix, ``traffic/<name>.json``;
and it has a file of its own, ``workloads/<cell>.json``, with its chip
count and the limits of its comparison.  A per-layer metric is read by
``metrics/<name>.py``'s ``read(record)``.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _by_name(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def _for_cell(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str, root: Path = ROOT) -> dict:
    """Everything one run of cell ``name`` needs, from its files."""
    bench = _load(root / "BENCHMARK.json")
    entry = _by_name(bench["workloads"], name, "workload")
    conf = _by_name(bench["configs"], entry["config"], "configuration")
    own = _load(root / "perfbench" / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if own[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key}={own[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    traffic = _load(root / "perfbench" / "traffic" / f"{entry['traffic']}.json")
    return {
        "name": name, "chips": entry["chips"],
        "model": _load(root / conf["file"])["model"],
        "traffic": traffic, "limits": own["limits"],
        "end_to_end": [m for m in bench["end_to_end"] if _for_cell(m, name)],
        "per_layer": [m for m in bench["per_layer"] if _for_cell(m, name)],
    }


def metric_reader(name: str, root: Path = ROOT
                  ) -> Callable[[dict], Optional[float]]:
    """``read`` of ``metrics/<name>.py``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
