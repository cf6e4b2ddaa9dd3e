"""``lm_head_kernel_ms``, the LM head's kernels' device time read from the
program's span ``repro_torch.lm_head``, on a trace built by hand: the
forward's launch inside the span on the loop's thread, the backward's two
inside the span that autograd's device thread opens, and a program without
the span, which reads nothing."""
import json

import pytest

from perfbench import spec, trace_read

SPAN = "repro_torch.lm_head"
VOCAB = 1000


def _x(cat, name, ts, dur, tid=1, pid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


def _events(span: bool):
    """Two traced steps of µs: a product outside the head, the head's
    forward kernel (20 µs) on the loop's thread, and its two backward
    kernels (30 and 40 µs) launched by autograd's device thread; with
    ``span``, each of the head's launches inside the program's span on
    its own thread."""
    ev = [_x("user_annotation", "perfbench.loop.step", 0, 400)]
    launches = [(5, 1, 1, "gemm_block", 10), (20, 2, 1, "lm_head_gemm", 20),
                (60, 3, 2, "lm_head_gemm", 30), (110, 4, 2, "lm_head_gemm",
                                                  40)]
    for ts, corr, tid, name, dur in launches:
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", ts, 1, tid=tid,
                     correlation=corr))
        ev.append(_x("kernel", name, ts + 2, dur, pid=0, tid=7,
                     correlation=corr))
    if span:
        ev += [_x("user_annotation", SPAN, 19, 5),
               _x("user_annotation", SPAN, 58, 60, tid=2)]
    return ev


def _record(tmp_path, span: bool):
    path = tmp_path / f"trace{int(span)}.json"
    path.write_text(json.dumps({"traceEvents": _events(span)}))
    tr = trace_read.read(str(path))
    tr.update(steps=2, ops_steps=1, wall_s=400e-6,
              attention={"fwd": [], "bwd": []})
    return {"trace": tr, "vocab": VOCAB}


def test_the_head_kernels_count_on_either_thread(tmp_path):
    read = spec.metric_reader("lm_head_kernel_ms")
    # (20 + 30 + 40) µs over 2 steps
    assert read(_record(tmp_path, True)) == pytest.approx(45e-3)


def test_a_program_without_the_span_reads_nothing(tmp_path):
    assert spec.metric_reader("lm_head_kernel_ms")(
        _record(tmp_path, False)) is None


def test_the_metric_is_declared_for_both_cells():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    entry = {m["name"]: m for m in bench["per_layer"]}["lm_head_kernel_ms"]
    assert entry["source"] == "program_span" and entry["layer"] == "model"
    assert entry["moves"] == "train_tokens_per_s"
    assert entry["workloads"] == ["internlm2-20b.train-4k",
                                  "mistral-7b.train-4k"]
