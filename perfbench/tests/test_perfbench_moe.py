"""The moe family (``families/moe.py``) and the cell
``mellum2-12b-a2.5b.train-8k``: what the yardstick counts of it, the
reference's layer-by-layer walk against one graph, its blocked attention
against the dense family's, the two readers of the held experts' spans
on a trace built by hand, and a tiny cell of the family run on the CPU
through the harness from its files."""
import json
import time

import pytest
import torch

from perfbench import (harness, inputs, reference, spec, trace_read,
                       train_cell)
from perfbench.families import dense
from perfbench.families import moe as fam
from conftest import tiny

CELL = "mellum2-12b-a2.5b.train-8k"
# the registry's smoke configuration of the port at the harness's tiny
# traffic: one L L L G period at window 8, 16 experts, 4 held, top-4
TINY_MOE = dict(n_layers=4, d_model=64, n_heads=4, n_kv=2, d_head=16,
                moe_d_ff=32, n_experts=16, top_k=4, experts_held=4,
                window=8, yarn_factor=4.0, yarn_original_max=32, vocab=512)


# the limits at those sizes, set as the cells' are (PERF.md, section 2),
# from 14 seeds on the CPU: the program (bf16) read at most gnorm1
# 1.25e-4, grad1 7.3e-3 and change 5.3e-3, the worst leaves the experts'
# (a token routed elsewhere moves one of the ~32 rows an expert sees
# here); the float8 control read gnorm1 7.3e-4 and more, grad1 9.2e-3
# and more (under 3x the program's: not an upper), change 2.8e-3; the
# half batch gnorm1 0.43, grad1 8.1e-2 and change 0.21 and more, the
# doubled leaf change 0.998, the missing clip grad1 7.8
TINY_MOE_LIMITS = {"gnorm1": 3.6e-4, "grad1": 0.031, "change": 0.048}


def _cell():
    out = tiny(spec.cell(CELL), **TINY_MOE)
    out["limits"] = dict(TINY_MOE_LIMITS)
    return out


def test_a_token_passes_through_998_7_million_weights():
    model = spec.cell(CELL)["model"]
    assert fam.token_weights(model) == 998_703_360
    # the same count by hand: every leaf but embed, the 8 held experts
    # at 8 of 64
    layer = 2 * 2304 + 2304 * (4096 + 2 * 512) + 4096 * 2304 + 2304 * 64
    experts = 8 * 3 * 2304 * 896
    assert 28 * (layer + experts * 8 // 64) + 2304 * 98304 + 2304 == \
        998_703_360


def test_three_windowed_layers_then_a_full_one():
    model = spec.cell(CELL)["model"]
    assert fam.attention_windows(model) == [1024, 1024, 1024, 0] * 7


def test_a_steps_flops_are_275_tflop():
    c = spec.cell(CELL)
    assert train_cell.step_flops(c["model"], c["traffic"]) == \
        275_010_262_401_024
    # 6 x weights x tokens + 12 D H x the 400,071,168 unmasked pairs of a
    # sequence's 28 layers x 4 sequences
    assert 6 * 998_703_360 * 4 * 8192 + 12 * 128 * 32 * 400_071_168 * 4 \
        == 275_010_262_401_024


def test_the_configuration_holds_the_published_keys():
    conf = json.loads((spec.ROOT / "perfbench/configs/mellum2-12b-a2.5b.json")
                      .read_text())
    model, pub = conf["model"], conf["published"]
    for key, value in pub.items():
        assert conf[key] == value, key
    assert (model["d_model"], model["n_heads"], model["n_kv"],
            model["d_head"]) == (pub["hidden_size"],
                                 pub["num_attention_heads"],
                                 pub["num_key_value_heads"], pub["head_dim"])
    assert (model["n_experts"], model["top_k"], model["moe_d_ff"]) == \
        (pub["num_experts"], pub["num_experts_per_tok"],
         pub["moe_intermediate_size"])
    assert conf["reduced"] == {"experts_held": {"published": 64, "here": 8}}
    full = pub["rope_parameters"]["full_attention"]
    assert (model["yarn_factor"], model["yarn_original_max"],
            model["yarn_beta_fast"], model["yarn_beta_slow"],
            model["yarn_attention_factor"]) == (
        full["factor"], full["original_max_position_embeddings"],
        full["beta_fast"], full["beta_slow"], full["attention_factor"])
    kinds = ["full_attention" if w == 0 else "sliding_attention"
             for w in fam.attention_windows(model)]
    assert kinds == pub["layer_types"]


@pytest.mark.parametrize("rows", [16, 1024])
def test_the_blocked_attention_is_the_dense_familys(rows, monkeypatch):
    monkeypatch.setattr(fam, "ATTN_ROWS", rows)
    g = torch.Generator().manual_seed(3)
    q = torch.randn((2, 64, 4, 16), generator=g)
    k = torch.randn((2, 64, 2, 16), generator=g)
    v = torch.randn((2, 64, 2, 16), generator=g)
    for window in (0, 8, 20):
        got = fam.attention(q, k, v, window, reference.no_cast)
        want = dense.attention(q, k, v, window, reference.no_cast)
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-6), window


def _one_graph(model, ref, tokens, labels):
    """The gradient of ``ce + AUX_WEIGHT x`` the layers' summed terms, by
    autograd over the whole loss at once, in float32."""
    params = {k: v.detach().float().requires_grad_()
              for k, v in ref.params.items()}
    x = fam.embed(params, tokens)
    total = 0.0
    for i in range(model["n_layers"]):
        prefix = f"layers.{i}."
        lp = {k[len(prefix):]: v for k, v in params.items()
              if k.startswith(prefix)}
        x, a = fam.block(model, x, lp, reference.no_cast, i)
        total = total + a
    loss = fam.loss(model, x, params, labels) + fam.AUX_WEIGHT * total
    loss.backward()
    return {k: v.grad for k, v in params.items()}, float(loss.detach())


@pytest.mark.parametrize("seed", [4, 2 ** 31 + 21])
def test_the_walk_is_the_one_graph_gradient_with_the_aux_term(
        seed, monkeypatch):
    monkeypatch.setattr(fam, "ATTN_ROWS", 16)  # several blocks a layer
    c = _cell()
    model, traffic = c["model"], c["traffic"]
    ref = reference.Reference(model, traffic, seed, torch.device("cpu"))
    b = {k: torch.as_tensor(v) for k, v in
         inputs.make_batch(model, traffic, seed, 0).items()}
    acc = {k: torch.zeros_like(v, dtype=torch.float32)
           for k, v in ref.params.items()}
    loss = ref.micro_batch(b["tokens"][:2], b["labels"][:2], acc)
    want, want_loss = _one_graph(model, ref, b["tokens"][:2],
                                 b["labels"][:2])
    assert set(acc) == set(want)
    for k in acc:
        assert float((acc[k] - want[k]).norm() / want[k].norm()) <= 1e-5, k
    assert loss == pytest.approx(want_loss, rel=1e-6)


def test_the_router_is_a_float32_leaf_and_the_experts_the_held_ones():
    model = spec.cell(CELL)["model"]
    specs = {s[0]: s for s in fam.leaf_specs(model)}
    assert specs["layers.moe.router"][1:] == ((28, 2304, 64), 0.02,
                                              "float32")
    assert specs["layers.moe.w_gate"][1] == (28, 8, 2304, 896)
    assert specs["layers.moe.w_down"][1] == (28, 8, 896, 2304)
    assert all(len(s) == 3 for name, s in specs.items()
               if name != "layers.moe.router")


# --- the readers of the held experts' spans ---------------------------------

def _x(cat, name, ts, dur, tid=1, pid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


N, K, M, G = 2048, 2304, 896, 8
# one call of each shape the experts launch: the forward's (N, K) x (G, K,
# M), dX's (N, M) x (G, M, K) and dW's (K, N) x (N, M)
SHAPES = [[[N, K], [G, K, M], [G], [], []],
          [[N, M], [G, M, K], [G], [], []],
          [[K, N], [N, M], [G], [], []]]


def _events(spans: bool):
    """Two traced steps in µs: a route kernel (10 µs) and a combine
    kernel (5 µs) on the loop's thread, the experts' forward product (40
    µs) there and the backward's two (50, 60 µs) on autograd's device
    thread, each product beside its 2 µs set-up kernel; with ``spans``,
    each launch inside the program's span on its own thread."""
    ev = [_x("user_annotation", "perfbench.loop.step", 0, 1000)]
    launches = [(5, 1, 1, "route", 10, None),
                (30, 2, 1, "prepare", 2, 0), (33, 3, 1, "gemm", 40, 0),
                (80, 4, 1, "combine", 5, None),
                (200, 5, 2, "prepare", 2, 1), (203, 6, 2, "gemm", 50, 1),
                (300, 7, 2, "prepare", 2, 2), (303, 8, 2, "gemm", 60, 2)]
    for ts, corr, tid, name, dur, shape in launches:
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", ts, 1, tid=tid,
                     correlation=corr))
        ev.append(_x("kernel", name, ts + 1, dur, pid=0, tid=7,
                     correlation=corr))
        if shape is not None:
            ev.append({**_x("cpu_op", "aten::_grouped_mm", ts - 1, 5,
                            tid=tid), "args": {"Input Dims": SHAPES[shape]}})
    if spans:
        ev += [_x("user_annotation", "repro_torch.moe.route", 4, 15),
               _x("user_annotation", "repro_torch.moe.experts", 28, 10),
               _x("user_annotation", "repro_torch.moe.combine", 79, 5),
               _x("user_annotation", "repro_torch.moe.experts", 198, 110,
                  tid=2)]
    return ev


def _record(tmp_path, spans: bool):
    path = tmp_path / f"trace{int(spans)}.json"
    path.write_text(json.dumps({"traceEvents": _events(spans)}))
    tr = trace_read.read(str(path))
    # the same launches stand for the shapes pass of one step
    tr.update(steps=2, ops_steps=1, wall_s=1000e-6,
              attention={"fwd": [], "bwd": []})
    return {"trace": tr, "vocab": 98304}


def test_the_experts_and_dispatch_spans_read_on_either_thread(tmp_path):
    rec = _record(tmp_path, True)
    # (2 + 40 + 2 + 50 + 2 + 60) µs over 2 steps
    assert spec.metric_reader("moe_experts_ms")(rec) == \
        pytest.approx(78e-3)
    # (10 + 5) µs over 2 steps
    assert spec.metric_reader("moe_dispatch_ms")(rec) == \
        pytest.approx(7.5e-3)


def test_a_program_without_the_spans_reads_nothing(tmp_path):
    rec = _record(tmp_path, False)
    for name in ("moe_experts_ms", "moe_dispatch_ms"):
        assert spec.metric_reader(name)(rec) is None, name


def test_the_metrics_are_declared_for_the_cell_alone():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name, source, layer in (
            ("moe_experts_ms", "program_span", "model"),
            ("moe_dispatch_ms", "program_span", "model")):
        m = entries[name]
        assert (m["source"], m["layer"], m["moves"]) == (
            source, layer, "train_tokens_per_s")
        assert m["workloads"] == [CELL]


# --- a tiny cell of the family through the harness ---------------------------

def test_a_tiny_cell_of_the_family_runs_and_is_correct(tmp_path, cpu):
    """The cell's files at the port's smoke widths, on the CPU: the
    program's loop against the family's reference, plain and traced."""
    c = _cell()
    plain = harness.execute(c, 2 ** 31 + 34, 0.3, False, cpu,
                            time.perf_counter(), str(tmp_path))
    traced = harness.execute(c, 2 ** 31 + 35, 0.3, True, cpu,
                             time.perf_counter(), str(tmp_path))
    assert plain["correct"] and traced["correct"], (plain["compare"],
                                                    traced["compare"])
    assert set(plain["compare"]) == set(TINY_MOE_LIMITS)
    # the CPU launches no device work: the spans hold no device time, and
    # the readers give nothing without raising
    for name in ("moe_experts_ms", "moe_dispatch_ms"):
        assert name not in traced["metrics"], name


@pytest.mark.parametrize("fault", ["half_batch", "double_leaf", "no_clip",
                                   "control"])
def test_the_tiny_cell_fails_a_planted_fault_and_the_control(fault, cpu):
    from perfbench import faults, judge
    c = _cell()
    seed = 2 ** 31 + 36
    ref = reference.readings(c["model"], c["traffic"], seed, cpu)
    if fault == "control":
        prog = reference.readings(c["model"], c["traffic"], seed, cpu,
                                  reference.fp8_cast)
    else:
        with faults.FAULTS[fault]():
            prog = train_cell.program_readings(c, seed, cpu)
    correct, _ = judge.verdict(prog, ref, c["limits"])
    assert not correct
