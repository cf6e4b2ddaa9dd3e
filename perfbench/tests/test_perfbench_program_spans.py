"""The per-layer metrics that read the program's spans
(``perfbench/program_spans.py``), on a trace built by hand: a step on the
loop's thread with the program's spans inside it, and autograd's device
thread launching the backward where no program span is open."""
import json

import pytest
import torch

from perfbench import spec, trace_read
from conftest import tiny

VOCAB = 1000
PHASES = ("forward_ms", "backward_ms", "grad_accum_ms", "optimizer_ms")
EXISTING = ("block_mm_ms", "attn_fwd_roofline", "attn_bwd_roofline",
            "device_idle_pct", "mfu", "loop_host_ms")
STEP = "repro_torch.train_step"
SUB = {"forward": STEP + ".forward", "backward": STEP + ".backward",
       "accumulate": STEP + ".accumulate", "adamw": "repro_torch.adamw.update"}


def _x(cat, name, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


def _launch(ts, corr, tid=1, dur=1):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, dur, tid=tid,
              correlation=corr)


def _kernel(name, ts, dur, corr):
    return _x("kernel", name, ts, dur, pid=0, tid=7, correlation=corr)


def _events(program: bool):
    """One traced step, µs; with ``program``, the program's spans too."""
    ev = [
        _x("user_annotation", "perfbench.loop.batch", 0, 10),
        _x("cuda_runtime", "cudaMemcpyAsync", 2, 1, correlation=1),
        _x("user_annotation", "perfbench.loop.step", 10, 190),
        _launch(13, 2),                                 # the sum's buffers
        _x("cpu_op", "aten::mm", 21, 9, **{"Input Dims": [[64, 8],
                                                          [8, VOCAB]]}),
        _launch(22, 3),                                 # the forward's head
        _launch(61, 4),                                 # autograd's ones
        # autograd's device thread: attention, then a launch held 10 µs
        _x("user_annotation", "perfbench.attn_bwd", 65, 15, tid=2),
        _launch(66, 5, tid=2),
        _x("cpu_op", "aten::mm", 99, 12, tid=2,
           **{"Input Dims": [[64, 8], [8, 8]]}),
        _launch(100, 6, tid=2, dur=10),
        _launch(121, 7),                                # a micro-batch's add
        _launch(131, 8),                                # AdamW
        _launch(180, 9),
        _x("cuda_runtime", "cudaStreamIsCapturing", 185, 10, correlation=20),
        _launch(192, 10),                               # step + 1
        _x("user_annotation", "perfbench.loop.readback", 200, 60),
        _x("cuda_runtime", "cudaMemcpyAsync", 201, 50, correlation=11),
        _x("gpu_memcpy", "Memcpy HtoD", 3, 2, pid=0, tid=7, correlation=1),
        _kernel("fill", 14, 4, 2),
        _kernel("gemm_head", 25, 20, 3),
        _kernel("fill_ones", 62, 1, 4),
        _kernel("flash_bwd", 70, 20, 5),
        _kernel("gemm_bwd", 110, 30, 6),
        _kernel("add", 140, 6, 7),
        _kernel("adam", 150, 20, 8),
        _kernel("adam", 182, 4, 9),
        _kernel("add_one", 192, 1, 10),
        _x("gpu_memcpy", "Memcpy DtoH", 250, 2, pid=0, tid=7, correlation=11),
        _kernel("no_launch", 300, 2, 12),
    ]
    if program:
        ev += [_x("user_annotation", name, ts, dur) for name, ts, dur in (
            (SUB["accumulate"], 12, 8),
            (SUB["forward"], 20, 40), (SUB["backward"], 60, 60),
            (SUB["accumulate"], 120, 10), (SUB["adamw"], 130, 55))]
    return ev


def _trace(tmp_path, program=True):
    path = tmp_path / f"trace{int(program)}.json"
    path.write_text(json.dumps({"traceEvents": _events(program)}))
    return str(path)


def _record(tr):
    call = {"b": 1, "h": 2, "hkv": 1, "s": 64, "d": 8, "causal": True,
            "window": 0, "itemsize": 2}
    tr.update(steps=1, ops_steps=1, wall_s=400e-6,
              attention={"fwd": [call], "bwd": [call]})
    return {"trace": tr, "vocab": VOCAB, "step_flops": 1e12,
            "tokens_per_step": 128,
            "window": {"steps": 2, "seconds": 1.0,
                       "parts": {p: [1e-3] * 2 for p in (
                           "batch", "gate", "step", "readback", "report")}}}


def _reads(record, names):
    return {m: spec.metric_reader(m)(record) for m in names}


def test_a_launch_from_autograds_thread_counts_under_the_open_span(tmp_path):
    read = _reads(_record(trace_read.read(_trace(tmp_path))), PHASES)
    # autograd's launches at 66 and 100 µs fall inside the loop thread's
    # backward (60..120 µs): 20 + 30 µs, with its own thread's 1 µs
    assert read["backward_ms"] == pytest.approx(51e-3)
    assert read["forward_ms"] == pytest.approx(20e-3)
    assert read["grad_accum_ms"] == pytest.approx(10e-3)
    assert read["optimizer_ms"] == pytest.approx(24e-3)


def test_the_program_spans_leave_the_existing_readings_as_they_were(
        tmp_path):
    with_spans = trace_read.read(_trace(tmp_path))
    without = trace_read.read(_trace(tmp_path, program=False))
    spans = with_spans.pop("spans_s")
    assert {k: v for k, v in spans.items()
            if not k.startswith("repro_torch.")} == without.pop("spans_s")
    assert with_spans == without
    assert _reads(_record(trace_read.read(_trace(tmp_path))), EXISTING) == \
        _reads(_record(trace_read.read(_trace(tmp_path, False))), EXISTING)


def test_the_phase_metrics_read_the_record(tmp_path):
    record = _record(trace_read.read(_trace(tmp_path)))
    read = _reads(record, PHASES)
    for metric, span in (("forward_ms", "forward"),
                         ("grad_accum_ms", "accumulate"),
                         ("optimizer_ms", "adamw")):
        assert read[metric] == pytest.approx(
            record["trace"]["spans_s"][SUB[span]] * 1e3), metric
    # the device time the trace places a step, less the loop's own copies
    # and the step's + 1, launched outside the four
    tr = record["trace"]
    placed = sum(tr["kernels_s"].values()) - tr["unplaced_s"]
    assert sum(read.values()) == pytest.approx((placed - 5e-6) * 1e3)


def test_the_phase_metrics_read_nothing_without_the_programs_spans(
        tmp_path):
    record = _record(trace_read.read(_trace(tmp_path, program=False)))
    assert _reads(record, PHASES) == dict.fromkeys(PHASES)


@pytest.mark.cuda
def test_a_traced_step_on_the_card_splits_into_its_four_phases(tmp_path):
    """The four phases of a traced step of a small model, together, are
    the device time the trace places a step, within 1%."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from perfbench import harness, train_cell
    cell = tiny(spec.cell("mistral-7b.train-4k"), d_model=512, n_heads=4,
                n_kv=2, d_ff=1024)
    cell["traffic"]["seq"] = 512
    res = train_cell.run(cell, 2 ** 31 + 13, 1.0, True,
                         torch.device("cuda", 0), 0.0, harness.log,
                         str(tmp_path))
    tr = res["record"]["trace"]
    phases = _reads(res["record"], PHASES)
    placed_ms = (sum(tr["kernels_s"].values()) - tr["unplaced_s"]) \
        / tr["steps"] * 1e3
    assert sum(phases.values()) == pytest.approx(placed_ms, rel=0.01)
