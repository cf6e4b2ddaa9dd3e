"""The harness: ``BENCHMARK.json`` against the contract's shape, every
file found by name, a cell added by new files alone, the result line,
the refusals without a chip, and the imports."""
import hashlib
import json
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness, spec
from conftest import ROOT, TINY_LIMITS, tiny

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_the_contracts_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_cell_config_traffic_and_metric_loads_by_name():
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"])
        assert cell["model"]["name"] == w["config"]
        assert set(cell["limits"]) == {"gnorm1", "grad1", "change"}
        assert [m["name"] for m in cell["per_layer"]] == \
            [m["name"] for m in BENCH["per_layer"]]
    for m in BENCH["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in sorted(root.rglob("*")) if p.is_file()
        and "__pycache__" not in p.parts}


def test_a_new_cell_runs_from_new_files_alone(tmp_path, cpu):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as new files and ``BENCHMARK.json`` entries, in a copy, run with no
    other file edited."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "perfbench")
    src = json.loads((ROOT / "perfbench/configs/internlm2-20b.json")
                     .read_text())
    src["model"].update(name="tiny-dense", n_layers=2, d_model=64,
                        n_heads=4, n_kv=2, d_ff=128, vocab=512)
    (tmp_path / "perfbench/configs/tiny-dense.json").write_text(
        json.dumps(src))
    traffic = json.loads((ROOT / "perfbench/traffic/train-4k.json")
                         .read_text())
    traffic.update(seq=32, seqs_per_step=2, n_micro=2)
    (tmp_path / "perfbench/traffic/train-32.json").write_text(
        json.dumps(traffic))
    limits = dict(TINY_LIMITS)
    (tmp_path / "perfbench/workloads/tiny-dense.train-32.json").write_text(
        json.dumps({"config": "tiny-dense", "traffic": "train-32",
                    "chips": 1, "limits": limits}))
    (tmp_path / "perfbench/metrics/window_steps.py").write_text(
        "def read(record):\n    return record['window']['steps']\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny-dense", "source": "test",
                             "file": "perfbench/configs/tiny-dense.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-dense.train-32",
                               "config": "tiny-dense",
                               "traffic": "train-32", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "window_steps", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "training loop",
                               "moves": "train_tokens_per_s",
                               "workloads": ["tiny-dense.train-32"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell("tiny-dense.train-32", tmp_path)
    assert [m["name"] for m in cell["per_layer"]] == ["window_steps"]
    plain = harness.execute(cell, 2 ** 31 + 7, 0.3, False, cpu,
                            time.perf_counter(), str(tmp_path), tmp_path)
    traced = harness.execute(cell, 2 ** 31 + 8, 0.3, True, cpu,
                             time.perf_counter(), str(tmp_path), tmp_path)
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"train_tokens_per_s", "peak_mem_gib",
                                     "setup_s"}
    assert traced["metrics"]["window_steps"]["value"] >= 1
    assert list(plain)[-1] == "compare"
    assert set(plain["compare"]) == set(limits)
    after = _digests(tmp_path / "perfbench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_run_refuses_without_cuda_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "internlm2-20b.train-4k", "--seed", str(2 ** 31 + 5),
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "cuda" in proc.stderr.lower()


def test_run_refuses_beside_no_program(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "internlm2-20b.train-4k", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


_IMPORTS = """
import sys, time, torch
sys.path[:0] = [{root!r}, {root!r} + "/src"]
torch.set_num_threads(2)
sys.path.insert(0, {tests!r})
from conftest import tiny
{body}
found = sorted({{n.split(".")[0] for n in sys.modules}} & {forbidden!r})
print(found)
"""


def _run_and_list(body, forbidden):
    code = _IMPORTS.format(root=str(ROOT), tests=str(ROOT / "perfbench/tests"),
                           body=body, forbidden=set(forbidden))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax_and_the_reference_none_of_the_program():
    # a whole run on the CPU, then the loaded modules' top-level names,
    # compared whole: repro_torch is not repro
    run = """
from perfbench import harness, spec, run
import tempfile
cell = tiny(spec.cell("mistral-7b.train-4k"))
with tempfile.TemporaryDirectory() as d:
    harness.execute(cell, 5, 0.2, True, torch.device("cpu"),
                    time.perf_counter(), d)
assert "repro_torch" in sys.modules
assert run.forbidden_modules() == []
"""
    assert _run_and_list(run, ("jax", "jaxlib", "flax", "repro")) == "[]"
    ref = """
from perfbench import judge, reference, spec
cell = tiny(spec.cell("internlm2-20b.train-4k"))
reference.readings(cell["model"], cell["traffic"], 5, torch.device("cpu"),
                   reference.fp8_cast)
"""
    assert _run_and_list(ref, ("jax", "jaxlib", "flax", "repro",
                               "repro_torch")) == "[]"


@pytest.mark.cuda
def test_a_tiny_cell_runs_and_traces_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = tiny(spec.cell("mistral-7b.train-4k"), d_model=256, n_heads=2,
                n_kv=1)
    out = harness.execute(cell, 2 ** 31 + 11, 1.0, True,
                          torch.device("cuda", 0), time.perf_counter(),
                          str(tmp_path))
    assert out["correct"], out["compare"]
    assert out["device"]["busy_s"] > 0
    for m in ("lm_head_ms", "block_mm_ms", "attn_fwd_roofline",
              "attn_bwd_roofline", "device_idle_pct"):
        assert m in out["metrics"], m
    assert 0 < out["metrics"]["attn_fwd_roofline"]["value"] <= 105
