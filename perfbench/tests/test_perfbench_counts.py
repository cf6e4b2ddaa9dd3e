"""The yardstick against hand counts: unmasked pairs, a step's model
FLOPs and an attention launch's bound."""
import math

import pytest

from perfbench import inputs, spec, workcount


@pytest.mark.parametrize("s,causal,window", [
    (7, True, 0), (7, False, 0), (9, True, 3), (16, True, 16), (16, True, 5),
])
def test_unmasked_pairs_match_a_loop_over_the_mask(s, causal, window):
    want = sum(1 for i in range(s) for j in range(s)
               if (not causal or j <= i)
               and (window <= 0 or i - j < window))
    assert workcount.unmasked_pairs(s, causal, window) == want


def test_unmasked_pairs_at_the_cells_lengths():
    # causal 4,096: S (S + 1) / 2; a window of 4,096 masks nothing there;
    # at 8,192 it leaves W (W + 1) / 2 + (S - W) W of S (S + 1) / 2
    assert workcount.unmasked_pairs(4096, True, 0) == 4096 * 4097 // 2
    assert workcount.unmasked_pairs(4096, True, 4096) == 4096 * 4097 // 2
    assert workcount.unmasked_pairs(8192, True, 4096) == \
        4096 * 4097 // 2 + 4096 * 4096 == 25_167_872
    assert workcount.unmasked_pairs(8192, True, 0) == 33_558_528


def _dense_params_by_hand(d, h, kv, hd, f, vocab, n):
    layer = d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * f + 2 * d
    return n * layer + 2 * vocab * d + d


@pytest.mark.parametrize("name", ["internlm2-20b", "mistral-7b"])
def test_a_steps_flops_match_the_hand_count(name):
    c = spec.cell(f"{name}.train-4k")
    m, t = c["model"], c["traffic"]
    shapes = {s[0]: s[1] for s in inputs.leaf_specs(m)}
    hd = m["d_model"] // m["n_heads"]
    total = _dense_params_by_hand(m["d_model"], m["n_heads"], m["n_kv"], hd,
                                  m["d_ff"], m["vocab"], m["n_layers"])
    assert sum(math.prod(s) for s in shapes.values()) == total
    tokens = t["seq"] * t["seqs_per_step"]
    pairs = t["seq"] * (t["seq"] + 1) // 2
    want = (6 * (total - m["vocab"] * m["d_model"]) * tokens
            + 12 * hd * m["n_heads"] * pairs * m["n_layers"]
            * t["seqs_per_step"])
    got = workcount.train_step_flops(shapes, m, t["seq"], t["seqs_per_step"],
                                     m["n_layers"])
    assert got == want
    # the issue's figures: 301 and ~382 TFLOP a step
    assert got / 1e12 == pytest.approx(
        {"internlm2-20b": 301.0, "mistral-7b": 382.4}[name], rel=2e-3)


def test_attention_bound_by_hand():
    call = {"b": 1, "h": 32, "hkv": 8, "s": 4096, "d": 128, "causal": True,
            "window": 0, "itemsize": 2}
    pairs = 4096 * 4097 // 2
    fwd_ops = 32 * pairs * 4 * 128
    bwd_ops = 32 * pairs * 10 * 128
    assert workcount.attention_bound_s(call, False) == pytest.approx(
        fwd_ops / 989e12)
    assert workcount.attention_bound_s(call, True) == pytest.approx(
        bwd_ops / 989e12)
    # a short sequence is bound by its bytes: q k v o dO dq dk dv and lse
    short = dict(call, s=64, h=8, hkv=8)
    q = 8 * 64 * 128 * 2
    fwd_bytes = 4 * q + 8 * 64 * 4
    bwd_bytes = 8 * q + 8 * 64 * 4
    assert workcount.attention_bound_s(short, False) == pytest.approx(
        max(8 * (64 * 65 // 2) * 4 * 128 / 989e12, fwd_bytes / 3.35e12))
    assert workcount.attention_bound_s(short, True) == pytest.approx(
        max(8 * (64 * 65 // 2) * 10 * 128 / 989e12, bwd_bytes / 3.35e12))
