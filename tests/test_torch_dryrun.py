"""The port's dry run (``launch/dryrun.py``) and its cost analysis
(``launch/cost_analysis.py``) against the JAX package's.

The analytic models -- ``model_flops``, ``_active_params``,
``flash_attention_bytes`` and the flash roofline's bytes -- equal the
reference's for every architecture and shape cell.  The cost analysis is
held to cases mirroring ``tests/test_hlo_analysis.py``: a matmul's FLOPs,
a loop's n iterations counted n times (eager mode unrolls it: no trip
count to resolve), the collectives' wire model, a collective in a loop.
The reference's own dry run cannot lower a sharded cell on this jax
(ROADMAP C6), so the traced cells are held to formulas: the collective
bytes of a smoke train step on a fake 4 x 1 mesh follow from the
parameters' placements, and every family's smoke config traces to
``status: ok`` on a fake 2 x 2 group.  Those cells run in a fresh
interpreter each (a fake process group must be the only one; one process
holds all its fake ranks), within 120 s; 10-25 s each on an idle host.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro import configs as jconfigs
from repro.launch import dryrun as jdryrun
from repro_torch import configs as tconfigs
from repro_torch.launch import cost_analysis as C
from repro_torch.launch import dryrun as tdryrun
from repro_torch.models.config import SHAPES
from repro_torch.runtime.steps import auto_microbatches

ROOT = Path(__file__).resolve().parents[1]
MESH_SHAPES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_analytic_models_equal_the_reference(arch, shape):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    sc = SHAPES[shape]
    assert tdryrun._active_params(tcfg) == jdryrun._active_params(jcfg)
    assert tdryrun.model_flops(tcfg, sc) == jdryrun.model_flops(jcfg, sc)
    for mesh in MESH_SHAPES:
        n_data = mesh["data"] * mesh.get("pod", 1)
        n_micro = auto_microbatches(tcfg, sc, n_data)
        assert tdryrun.flash_attention_bytes(tcfg, sc, n_micro, mesh) == \
            jdryrun.flash_attention_bytes(jcfg, sc, n_micro, mesh)
        info = {"attention_hbm_bytes": 3.0e12, "n_micro": n_micro,
                "cost": {"flops": 1.0e15, "bytes": 7.0e12},
                "roofline": {"compute_s": 1.25, "collective_s": 0.5},
                "mesh": "2x16x16" if "pod" in mesh else "16x16"}
        want = jdryrun.optimized_roofline(info, jcfg, sc)
        got = tdryrun.optimized_roofline(info, tcfg, sc)
        for k in ("compute_s", "collective_s", "attention_bytes_removed",
                  "flash_bytes_added"):
            assert got[k] == want[k], k
        # the same bytes over each package's memory rate (H100, v5e)
        assert got["memory_s"] * tdryrun.HBM_BW == pytest.approx(
            want["memory_s"] * jdryrun.HBM_BW, rel=1e-12)


def test_h100_constants():
    assert (tdryrun.PEAK_FLOPS, tdryrun.HBM_BW, tdryrun.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    assert not hasattr(tdryrun, "ICI_BW")


def _trace(fn, *args):
    with C.ScopeTags(), C.OpTrace() as tr:
        fn(*args)
    return C.analyze(tr.ops)


class TestFlops:
    def test_single_matmul(self):
        a, b = torch.randn(128, 256), torch.randn(256, 64)
        r = _trace(lambda x, y: x @ y, a, b)
        assert r["flops"] == 2 * 128 * 256 * 64
        assert r["hbm_bytes"] == 4 * (128 * 256 + 256 * 64 + 128 * 64)

    def test_loop_counts_every_iteration(self):
        w, x = torch.randn(128, 128), torch.randn(8, 128)

        def f(x, w):
            for _ in range(12):
                x = x @ w
            return x
        r = _trace(f, x, w)
        assert r["flops"] == 12 * 2 * 8 * 128 * 128
        assert r["n_warnings"] == 0

    def test_micro_batches_count_n_times(self):
        """n micro-batches of a matmul, forward and backward: n times one."""
        w = torch.randn(64, 32, requires_grad=True)
        x = torch.randn(16, 64)

        def f(n):
            for xs in x.chunk(n):
                torch.autograd.grad((xs @ w).sum(), w)
        one, four = _trace(f, 1), _trace(f, 4)
        # forward and weight gradient: 2 matmuls of 2 * 16 * 64 * 32 in all
        assert four["flops"] == one["flops"] == 2 * 2 * 16 * 64 * 32

    def test_elementwise_counts_one_per_element(self):
        x = torch.randn(32, 16)
        r = _trace(lambda x: torch.exp(x) + x, x)
        assert r["flops"] == 2 * 32 * 16

    def test_views_move_nothing(self):
        x = torch.randn(32, 16)
        r = _trace(lambda x: x.view(16, 32).transpose(0, 1)[3:], x)
        assert r["hbm_bytes"] == 0 and r["flops"] == 0

    def test_attention_scope_includes_the_backward(self):
        from repro_torch.models import layers
        q = torch.randn(1, 8, 2, 16, requires_grad=True)
        k = torch.randn(1, 8, 2, 16, requires_grad=True)
        v = torch.randn(1, 8, 2, 16, requires_grad=True)

        def f():
            out = layers.chunked_attention(q, k, v, causal=True, chunk=4)
            (out * 2.0).sum().backward()
        with C.ScopeTags(), C.OpTrace() as tr:
            f()
        scoped = [r for r in tr.ops if r["scope"] == C.ATTENTION]
        assert any(r["op"] == "bmm" for r in scoped)
        assert len(scoped) < len(tr.ops)  # the outer mul and sum are not
        r = C.analyze(tr.ops)
        assert 0 < r["attention_hbm_bytes"] < r["hbm_bytes"]


def _policy_step(cfg, policy: str):
    """One smoke train step (one micro-batch) under ``policy``, traced,
    and the forward alone under ``no_grad``."""
    import dataclasses
    from repro_torch import models, optim
    from repro_torch.runtime import steps
    cfg = dataclasses.replace(cfg, remat=True, remat_policy=policy)
    opt = optim.AdamWConfig(lr=1e-3, warmup_steps=0)
    state = steps.init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                                   "cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(1, cfg.vocab, (2, 16), generator=gen)
             for k in ("tokens", "labels")}
    with torch.no_grad(), C.ScopeTags(), C.OpTrace() as fwd:
        models.forward(state.params, cfg, batch["tokens"])
    with C.ScopeTags(), C.OpTrace() as step:
        steps.build_train_step(cfg, opt, n_micro=1)(state, batch)
    return fwd.ops, step.ops


@pytest.mark.parametrize("arch", ["llama3-8b", "recurrentgemma-2b"])
def test_a_dots_step_counts_each_unbatched_product_three_times(arch):
    """Under ``remat_policy="dots"`` the recompute takes each product
    without batch dims from the forward's saved outputs, where the trace
    does not see it: every such product is counted three times a step (the
    forward and its two gradients), where ``"nothing"`` adds the
    recompute's.  Batched products and the attention scope (chunked
    attention is rerun under both) count as before."""
    cfg = tconfigs.get_smoke_config(arch)
    fwd, dots = _policy_step(cfg, "dots")
    _, nothing = _policy_step(cfg, "nothing")

    def n(trace, op):
        return sum(r["op"] == op for r in trace)

    assert n(dots, "mm") == 3 * n(fwd, "mm")
    # all but the last product of each block is recomputed under "nothing"
    blocks = cfg.n_layers if cfg.family != "griffin" else \
        cfg.n_layers // 3 + cfg.n_layers % 3
    assert n(nothing, "mm") == n(dots, "mm") + n(fwd, "mm") - 1 - blocks
    assert n(dots, "bmm") == n(nothing, "bmm") > n(fwd, "bmm") > 0
    d, z = C.analyze(dots), C.analyze(nothing)
    assert 0 < d["attention_hbm_bytes"] == z["attention_hbm_bytes"]
    assert d["flops"] < z["flops"]
    assert sum(r["scope"] == C.ATTENTION for r in dots) == \
        sum(r["scope"] == C.ATTENTION for r in nothing)


def _collective(name, x, *extra):
    op = getattr(torch.ops._c10d_functional, name)
    return torch.ops._c10d_functional.wait_tensor(op(x, *extra, "g"))


class TestCollectives:
    """Functional collectives on meta tensors: shapes only, no group."""

    def test_all_reduce_moves_twice_its_operand(self):
        x = torch.empty(1024, 256, device="meta")
        r = _trace(lambda: _collective("all_reduce", x, "sum"))
        assert r["collective_bytes"] == 2 * 1024 * 256 * 4
        assert r["per_collective"]["all-reduce"] == 2 * 1024 * 256 * 4

    def test_all_gather_moves_its_gathered_result(self):
        x = torch.empty(64, 256, dtype=torch.bfloat16, device="meta")
        r = _trace(lambda: _collective("all_gather_into_tensor", x, 8))
        assert r["per_collective"]["all-gather"] == 512 * 256 * 2

    def test_reduce_scatter_moves_its_operand(self):
        x = torch.empty(512, 256, dtype=torch.bfloat16, device="meta")
        r = _trace(lambda: _collective("reduce_scatter_tensor", x, "sum", 8))
        assert r["per_collective"]["reduce-scatter"] == 512 * 256 * 2

    def test_collective_inside_loop_scaled(self):
        x = torch.empty(128, device="meta")

        def f():
            for _ in range(9):
                _collective("all_reduce", x, "sum")
        r = _trace(f)
        assert r["per_collective"]["all-reduce"] == 2 * 9 * 128 * 4


def _run_cells(code: str, cwd: Path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


_CELL = """
import json
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.models.config import ShapeConfig
out = {{}}
for shape, ov in {cells!r}:
    out[shape] = dryrun.lower_cell({arch!r}, shape, {multi!r},
                                   opt_overrides=ov,
                                   cfg=get_smoke_config({arch!r}),
                                   mesh_shape={mesh!r},
                                   shape=ShapeConfig(*{small!r}[shape]))
print(json.dumps(out))
"""
# the cells' kinds at a size whose trace takes seconds: DTensor plans each
# redistribution of a strided shard over the whole dim
SMALL = {"train_4k": ("train_4k", 512, 8, "train"),
         "prefill_32k": ("prefill_32k", 1024, 4, "prefill"),
         "decode_32k": ("decode_32k", 1024, 8, "decode")}


@pytest.mark.parametrize("arch", ["llama3_8b", "qwen2_moe_a2_7b",
                                  "recurrentgemma_2b", "xlstm_125m",
                                  "whisper_small"])
def test_every_family_traces_on_a_fake_2x2_group(arch, tmp_path):
    cells = [("train_4k", {"n_micro": 2 if arch == "llama3_8b" else 1}),
             ("decode_32k", None)]
    if arch == "recurrentgemma_2b":  # the RG-LRU's shape-only op
        cells.append(("prefill_32k", None))
    got = _run_cells(_CELL.format(cells=cells, arch=arch, small=SMALL,
                                  multi=False,
                                  mesh={"data": 2, "model": 2}), tmp_path)
    for shape, _ in cells:
        info = got[shape]
        assert info["status"] == "ok", (shape, info)
        assert info["chips"] == 4 and info["mesh"] == "2x2"
        assert info["cost"]["flops"] > 0 and info["cost"]["bytes"] > 0
        assert info["bottleneck"] in ("compute", "memory", "collective")
        assert info["memory"]["peak_bytes"] >= info["memory"][
            "argument_bytes"] > 0
        assert sum(info["collectives"].values()) == info[
            "collective_bytes_total"] > 0, shape


def test_a_cell_traces_on_a_fake_pod_mesh(tmp_path):
    """The multi-pod layout, ("pod", "data", "model") at 2 x 2 x 2: the
    batch splits over ("pod", "data") together."""
    cells = [("train_4k", {"n_micro": 1})]
    got = _run_cells(_CELL.format(cells=cells, arch="llama3_8b",
                                  small=SMALL, multi=True,
                                  mesh={"pod": 2, "data": 2, "model": 2}),
                     tmp_path)
    for shape, _ in cells:
        info = got[shape]
        assert info["status"] == "ok", (shape, info)
        assert info["mesh"] == "2x2x2" and info["chips"] == 8
        assert info["collectives"].get("all-gather", 0) > 0, shape


def test_collective_bytes_of_an_fsdp_step_follow_the_placements(tmp_path):
    """A smoke Llama train step (one micro-batch, float32 AdamW) on a fake
    4 x 1 mesh: FSDP only, every weight split 4 ways on its "w_embed" dim.
    Each split gradient is reduce-scattered once from its whole (stacked)
    size, the embedding table's too (gathered over its embed dim for the
    vocab-parallel lookup, its gradient a pending sum over the batch
    rows); the replicated norm scales' gradients and the loss's three
    scalar sums (float32 cross entropy and aux, int64 token count) are
    all-reduced (2 x the operand); each split layer weight is
    gathered whole (``gather_fsdp``) for the forward and again for remat's
    recompute, the embedding table and the head once (an all-gather moves
    its gathered result)."""
    from repro_torch.models import abstract_params, logical_specs
    from repro_torch.sharding import AbstractMesh, AxisRules, best_spec
    cfg = tconfigs.get_smoke_config("llama3_8b")
    got = _run_cells(_CELL.format(cells=[("train_4k", {"n_micro": 1})],
                                  arch="llama3_8b", small=SMALL, multi=False,
                                  mesh={"data": 4, "model": 1}),
                     tmp_path)["train_4k"]
    assert got["status"] == "ok"
    rules = AxisRules(AbstractMesh((4, 1), ("data", "model")))
    params, specs = abstract_params(cfg), logical_specs(cfg)
    split = replicated = layers = 0
    for key in sorted(params):
        for p, s in _leaves(params[key], specs[key]):
            nbytes = p.numel() * p.element_size()
            if "data" in tuple(best_spec(p.shape, s, rules)):
                split += nbytes
                if key == "layers":
                    layers += nbytes
            else:
                replicated += nbytes
    embed = params["embed"].numel() * params["embed"].element_size()
    head = params["head"].numel() * params["head"].element_size()
    per = got["collectives"]
    assert per["reduce-scatter"] == split
    assert per["all-reduce"] == 2 * (replicated + 4 + 4 + 8)
    assert per["all-gather"] == 2 * layers + embed + head


def _leaves(p, s):
    if isinstance(p, dict):
        for k in sorted(p):
            yield from _leaves(p[k], s[k])
    else:
        yield p, s
