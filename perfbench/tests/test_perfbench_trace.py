"""The trace reader and the per-layer metrics on a trace built by hand:
kernels tied to their launches by correlation id, launches to the
innermost operator and the benchmark's spans around them, on two host
threads (the loop's and autograd's)."""
import json

import pytest

from perfbench import spec, trace_read

VOCAB = 1000


def _x(cat, name, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


def _trace(tmp_path):
    ev = [
        # the loop's thread: a step with the head's product in the forward
        _x("user_annotation", "perfbench.loop.step", 0, 100),
        _x("cpu_op", "aten::matmul", 1, 20),
        _x("cpu_op", "aten::mm", 2, 10,
           **{"Input Dims": [[64, 8], [8, VOCAB]]}),
        _x("cuda_runtime", "cudaLaunchKernel", 3, 1, correlation=1),
        _x("user_annotation", "perfbench.attn_fwd", 30, 10),
        _x("cpu_op", "aten::empty", 31, 1),
        _x("cuda_driver", "cuLaunchKernel", 33, 1, correlation=2),
        _x("cpu_op", "aten::mm", 50, 5, **{"Input Dims": [[64, 8], [8, 8]]}),
        _x("cuda_runtime", "cudaLaunchKernel", 51, 1, correlation=3),
        _x("user_annotation", "perfbench.loop.readback", 100, 50),
        # autograd's thread: the backward's product and attention
        _x("user_annotation", "perfbench.attn_bwd", 60, 10, tid=2),
        _x("cuda_runtime", "cudaLaunchKernel", 61, 1, tid=2, correlation=4),
        _x("cpu_op", "aten::mm", 70, 5, tid=2,
           **{"Input Dims": [[VOCAB, 64], [64, 8]]}),
        _x("cuda_runtime", "cudaLaunchKernel", 71, 1, tid=2, correlation=5),
        # device: one stream; kernel 6 has no launch in the trace
        _x("kernel", "gemm_head", 10, 20, pid=0, tid=7, correlation=1),
        _x("kernel", "flash_fwd", 35, 10, pid=0, tid=7, correlation=2),
        _x("kernel", "gemm_block", 52, 4, pid=0, tid=7, correlation=3),
        _x("kernel", "flash_bwd_dkdv", 62, 6, pid=0, tid=7, correlation=4),
        _x("kernel", "gemm_head_bwd", 72, 8, pid=0, tid=7, correlation=5),
        _x("gpu_memcpy", "Memcpy DtoH", 120, 2, pid=0, tid=7,
           correlation=6),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_reader_ties_kernels_to_operators_and_spans(tmp_path):
    tr = trace_read.read(_trace(tmp_path))
    # union of [10,30] [35,45] [52,56] [62,68] [72,80] [120,122] µs
    assert tr["busy_s"] == pytest.approx(50e-6)
    assert tr["spans_s"]["perfbench.attn_fwd"] == pytest.approx(10e-6)
    assert tr["spans_s"]["perfbench.attn_bwd"] == pytest.approx(6e-6)
    assert tr["spans_s"]["perfbench.loop.step"] == pytest.approx(34e-6)
    assert tr["unplaced_s"] == pytest.approx(2e-6)
    # the launches with an operator around them: the three products (the
    # attention launches sit in no operator here)
    assert sorted(s for name, _, s in tr["ops"] if name == "aten::mm") == \
        pytest.approx([4e-6, 8e-6, 20e-6])
    assert len(tr["ops"]) == 3
    # the longest gap, 80..120 µs, falls inside the loop's step span
    assert tr["idle_gaps"][0] == ["perfbench.loop.step",
                                  pytest.approx(40e-6)]
    assert len(tr["idle_gaps"]) == 5


def test_metrics_read_the_record(tmp_path):
    tr = trace_read.read(_trace(tmp_path))
    call = {"b": 1, "h": 2, "hkv": 1, "s": 64, "d": 8, "causal": True,
            "window": 0, "itemsize": 2}
    tr.update(steps=2, ops_steps=2, wall_s=200e-6,
              attention={"fwd": [call, call], "bwd": [call]})
    record = {"trace": tr, "vocab": VOCAB, "step_flops": 1e12,
              "tokens_per_step": 128,
              "window": {"steps": 4, "seconds": 2.0,
                         "parts": {"batch": [1e-3] * 4, "gate": [0] * 4,
                                   "step": [0.4] * 4, "readback": [0.1] * 4,
                                   "report": [2e-3] * 4}}}
    read = {m: spec.metric_reader(m)(record) for m in (
        "lm_head_ms", "block_mm_ms", "attn_fwd_roofline", "attn_bwd_roofline",
        "device_idle_pct", "mfu", "loop_host_ms")}
    assert read["lm_head_ms"] == pytest.approx((20 + 8) * 1e-3 / 2)
    assert read["block_mm_ms"] == pytest.approx(4 * 1e-3 / 2)
    from perfbench.workcount import attention_bound_s
    assert read["attn_fwd_roofline"] == pytest.approx(
        100 * 2 * attention_bound_s(call, False) / 10e-6)
    assert read["attn_bwd_roofline"] == pytest.approx(
        100 * attention_bound_s(call, True) / 6e-6)
    assert read["device_idle_pct"] == pytest.approx(75.0)
    assert read["mfu"] == pytest.approx(100 * 1e12 / 0.5 / 989e12)
    assert read["loop_host_ms"] == pytest.approx(3.0)


def test_a_reader_with_nothing_to_read_returns_none(tmp_path):
    tr = trace_read.read(_trace(tmp_path))
    tr.update(steps=1, ops_steps=1, wall_s=1.0,
              attention={"fwd": [], "bwd": []}, ops=[])
    record = {"trace": tr, "vocab": VOCAB}
    for m in ("lm_head_ms", "block_mm_ms", "attn_fwd_roofline",
              "attn_bwd_roofline"):
        assert spec.metric_reader(m)(record) is None
