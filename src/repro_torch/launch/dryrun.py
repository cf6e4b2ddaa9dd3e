"""Multi-pod dry run: trace every (arch x shape x mesh) cell on a fake
process group (the JAX package's ``launch/dryrun.py``).

For each cell the real train / prefill / serve step runs once, eagerly,
on DTensors over a fake process group of 256 (16x16) or 512 (2x16x16)
ranks whose local tensors are on the meta device: they carry shapes and
dtypes, nothing is allocated or computed, and collectives move nothing.
(``FakeTensorMode`` was the first choice; DTensor's own sharding
propagation reads tensor values for strided shards, which fake tensors
refuse.)  The tensors are not on a card, so the plain PyTorch versions run
(chunked attention, not the flash kernel), as the JAX package lowers on
forced host devices; ``optimized_roofline`` models the kernel.  The
RG-LRU recurrence runs in its shape-only form, one op a call.
``cost_analysis.OpTrace`` records rank 0's aten ops; their FLOPs, bytes
and collective bytes give the per-rank roofline with H100 constants.  The trace is dumped gzipped under
``results/trace/`` (the JAX package dumps HLO); ``launch.reanalyze``
re-reads it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k --mesh single --out results/dryrun.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from .. import configs as config_registry
from .._tree import leaves, tree_map
from ..data.pipeline import make_batch_specs
from ..models import abstract_params, init_cache, logical_specs
from ..models.config import SHAPES, ModelConfig, ShapeConfig
from ..models.model import cache_logical
from ..optim import AdamWConfig, adamw_init
from ..runtime.steps import (TrainState, auto_microbatches,
                             build_prefill_step, build_serve_step,
                             build_train_step)
from ..sharding import AxisRules, best_spec, placements, use_rules
from . import cost_analysis
from .mesh import make_production_mesh

# NVIDIA H100 SXM constants (per GPU)
PEAK_FLOPS = 989e12  # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12  # bytes/s
LINK_BW = 450e9  # bytes/s, NVLink 4, one direction


# ---------------------------------------------------------------------------
# Sharding helpers
# ---------------------------------------------------------------------------

def param_shardings(mesh, shapes_tree, spec_tree, rules=None):
    """Each parameter's DTensor placements on ``mesh``."""
    rules = rules or AxisRules(mesh)
    return tree_map(lambda t, s: placements(best_spec(t.shape, s, rules),
                                            mesh), shapes_tree, spec_tree)


def batch_shardings(mesh, batch_specs, rules=None):
    rules = rules or AxisRules(mesh)
    out = {}
    for k, v in batch_specs.items():
        if k == "positions":  # (3, B, S)
            logical = (None, "batch", None)
        else:
            logical = ("batch",) + (None,) * (v.dim() - 1)
        out[k] = placements(best_spec(v.shape, logical, rules), mesh)
    return out


def input_specs(arch: str, shape_name: str) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input of a cell."""
    cfg = config_registry.get_config(arch)
    shape = SHAPES[shape_name]
    return make_batch_specs(cfg, shape)


# Alternative sharding layouts for the perf loop (section Perf):
# pure_fsdp -- no tensor parallelism; weights fully sharded over every mesh
# axis and gathered layer-wise (right-sizes small-dense models where TP
# activation psums dominate the collective term).
RULES_PRESETS = {
    # pod axis used as additional FSDP for weights/optimizer (instead of
    # pure DP) -- the 1000+-node memory story for the giants
    "pod_fsdp": {
        "w_embed": [("pod", "data"), "data", None],
        "w_vocab": ["model", None],
    },
    "pure_fsdp": {
        "batch": [("pod", "data", "model"), ("data", "model"), None],
        "heads": [None], "kv_heads": [None],
        "mlp_act": [None], "vocab_act": [None], "experts_act": [None],
        "w_embed": [("data", "model"), "data", None],
        "w_heads": [None], "w_mlp": [None],
        "w_vocab": [("data", "model"), "data", None],
        "w_state": [None],
    },
}


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """A fake process group of ``n_ranks`` ranks in this one process (this
    process is rank 0): collectives return at once and move nothing.  An
    existing default group must be that one; a group made here is torn
    down on exit."""
    # the fake backend lives in torch's testing package; importing the
    # module registers it
    from torch.testing._internal.distributed.fake_pg import FakeStore
    made = False
    if dist.is_initialized():
        if dist.get_world_size() != n_ranks or dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()} process group of "
                f"{dist.get_world_size()} ranks exists; the dry run needs a "
                f"fake one of {n_ranks}: run it in its own process")
    else:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n_ranks)
        made = True
    try:
        yield
    finally:
        if made:
            dist.destroy_process_group()


def _local_bytes(tree) -> int:
    n = 0
    for x in leaves(tree):
        t = x.to_local() if isinstance(x, DTensor) else x
        n += t.numel() * t.element_size()
    return n


def _meta_dtensor(meta: torch.Tensor, layout, mesh) -> torch.Tensor:
    """A DTensor of meta tensors with the shape and dtype of ``meta`` and
    the given placements."""
    whole = DTensor.from_local(torch.empty(meta.shape, dtype=meta.dtype,
                                           device="meta"), mesh,
                               [Replicate()] * mesh.ndim, run_check=False)
    return whole.redistribute(mesh, layout)


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               opt_overrides: Optional[Dict] = None,
               cfg: Optional[ModelConfig] = None,
               mesh_shape: Optional[Dict[str, int]] = None,
               shape: Optional[ShapeConfig] = None) -> Dict[str, Any]:
    """Trace one cell; returns its roofline record.  ``cfg`` replaces the
    arch's full-size config, ``mesh_shape`` (e.g. ``{"data": 2, "model":
    2}``) the production mesh and ``shape`` the named shape cell: all
    three are for small checks."""
    from torch.distributed.device_mesh import init_device_mesh
    cfg = cfg or config_registry.get_config(arch)
    if opt_overrides and opt_overrides.get("cfg_replace"):
        cfg = dataclasses.replace(cfg, **opt_overrides["cfg_replace"])
    shape = shape or SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return {"status": "skipped",
                "reason": "full-attention arch at 524k context (see DESIGN.md)"}
    if mesh_shape is None:
        mesh_shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
                      else {"data": 16, "model": 16})
    n_ranks = 1
    for n in mesh_shape.values():
        n_ranks *= n

    with fake_world(n_ranks):
        if n_ranks in (256, 512) and len(mesh_shape) == (3 if multi_pod
                                                         else 2):
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        else:
            mesh = init_device_mesh("cpu", tuple(mesh_shape.values()),
                                    mesh_dim_names=tuple(mesh_shape))
        return _trace_cell(arch, shape_name, shape, cfg, mesh, mesh_shape,
                           multi_pod, opt_overrides)


def _trace_cell(arch, shape_name, shape, cfg, mesh, mesh_shape, multi_pod,
                opt_overrides) -> Dict[str, Any]:
    rules_over = None
    if opt_overrides and opt_overrides.get("rules_preset"):
        rules_over = RULES_PRESETS[opt_overrides["rules_preset"]]
    rules = AxisRules(mesh, rules_over)
    n_data = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    if rules_over is not None:
        n_data *= mesh_shape.get("model", 1)  # batch spans every axis

    t0 = time.time()
    param_meta = abstract_params(cfg)
    logical = logical_specs(cfg)
    batch_meta = make_batch_specs(cfg, shape)
    info: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(n) for n in mesh_shape.values()),
        "params": int(sum(x.numel() for x in leaves(param_meta))),
    }
    trace = cost_analysis.OpTrace()
    with use_rules(mesh, rules_over):
        params = tree_map(lambda m, p: _meta_dtensor(m, p, mesh), param_meta,
                          param_shardings(mesh, param_meta, logical, rules))
        b_shard = batch_shardings(mesh, batch_meta, rules)
        batch = {k: _meta_dtensor(v, b_shard[k], mesh)
                 for k, v in batch_meta.items()}
        if shape.kind == "train":
            big = info["params"] > 1e11
            opt_cfg = AdamWConfig(
                moment_dtype=torch.bfloat16 if big else torch.float32)
            n_micro = auto_microbatches(cfg, shape, n_data)
            accum = torch.bfloat16 if big else torch.float32
            if opt_overrides:
                n_micro = opt_overrides.get("n_micro", n_micro)
            specs_for_grads = logical if (
                opt_overrides and opt_overrides.get("grad_rs")) else None
            step_fn = build_train_step(cfg, opt_cfg, n_micro,
                                       accum_dtype=accum,
                                       param_specs=specs_for_grads)
            state = TrainState(params, adamw_init(opt_cfg, params),
                               torch.zeros((), dtype=torch.int32,
                                           device="meta"))
            info["n_micro"] = n_micro
            info["memory"] = {"argument_bytes": _local_bytes(state)
                              + _local_bytes(batch)}
            run = lambda: step_fn(state, batch)  # noqa: E731
        elif shape.kind == "prefill":
            step_fn = build_prefill_step(cfg)
            info["memory"] = {"argument_bytes": _local_bytes(params)
                              + _local_bytes(batch)}
            run = lambda: step_fn(params, batch)  # noqa: E731
        else:  # decode
            step_fn = build_serve_step(cfg)
            c_logical = cache_logical(
                cfg, head_sharded=bool(opt_overrides
                                       and opt_overrides.get("kv_head_shard")))
            cache_meta = init_cache(cfg, shape.global_batch, shape.seq_len,
                                    device="meta")
            cache = {k: v if k == "index" else _meta_dtensor(
                v, placements(best_spec(v.shape, c_logical[k], rules), mesh),
                mesh) for k, v in cache_meta.items()}
            cache["index"] = torch.zeros((), dtype=torch.int32,
                                         device="meta")
            info["memory"] = {"argument_bytes": _local_bytes(params)
                              + _local_bytes(cache)
                              + _local_bytes(batch["tokens"])}
            run = lambda: step_fn(params, cache, batch["tokens"])  # noqa
        info["setup_s"] = round(time.time() - t0, 1)
        t1 = time.time()
        with cost_analysis.ScopeTags(), trace:
            out = run()
        del out
        info["trace_s"] = round(time.time() - t1, 1)

    info["memory"]["temp_bytes"] = trace.peak_bytes
    info["memory"]["peak_bytes"] = (info["memory"]["argument_bytes"]
                                    + trace.peak_bytes)
    if opt_overrides is None or opt_overrides.get("dump_trace", True):
        os.makedirs("results/trace", exist_ok=True)
        tag = (opt_overrides or {}).get("tag", "")
        cell_id = f"{arch}__{shape_name}__{'multi' if multi_pod else 'single'}"
        if tag:
            cell_id += f"__{tag}"
        with gzip.open(f"results/trace/{cell_id}.json.gz", "wt") as f:
            json.dump(trace.ops, f)
    _fill_roofline(info, cost_analysis.analyze(trace.ops), cfg, shape,
                   mesh_shape)
    info["status"] = "ok"
    return info


def _fill_roofline(info: Dict[str, Any], hc: Dict[str, Any],
                   cfg: ModelConfig, shape: ShapeConfig,
                   mesh_shape: Dict[str, int]) -> None:
    """The counted cost, collectives and roofline terms of a cell (per rank
    program), with the model's FLOPs beside the counted ones."""
    info["cost"] = {"flops": hc["flops"], "bytes": hc["hbm_bytes"]}
    info["attention_hbm_bytes"] = hc["attention_hbm_bytes"]
    info["collectives"] = hc["per_collective"]
    info["collective_bytes_total"] = int(hc["collective_bytes"])
    info["trace_warnings"] = hc["n_warnings"]
    chips = 1
    for n in mesh_shape.values():
        chips *= n
    info["chips"] = chips
    info["roofline"] = {
        "compute_s": info["cost"]["flops"] / PEAK_FLOPS,
        "memory_s": info["cost"]["bytes"] / HBM_BW,
        "collective_s": info["collective_bytes_total"] / LINK_BW,
    }
    dom = max(info["roofline"], key=info["roofline"].get)
    info["bottleneck"] = dom.replace("_s", "")
    info["model_flops_global"] = model_flops(cfg, shape)
    per_chip = info["model_flops_global"] / chips
    info["model_vs_counted_flops"] = (per_chip / info["cost"]["flops"]
                                      if info["cost"]["flops"] else None)
    info["roofline_flash"] = optimized_roofline(info, cfg, shape,
                                                mesh_shape)


def flash_attention_bytes(cfg: ModelConfig, shape: ShapeConfig,
                          n_micro: int, mesh_shape: Dict[str, int]) -> float:
    """Per-chip HBM traffic of attention under the flash kernel: q, k, v
    read + o written per pass; scores never leave on-chip memory.

    Training runs ~3 passes (fwd + remat-fwd + bwd reading q,k,v,o,do);
    prefill 1. Used to model the roofline where the kernel replaces the
    chunked path (see EXPERIMENTS.md section Perf).
    """
    if cfg.family in ("xlstm",):
        return 0.0  # no softmax attention
    dp = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    tp = mesh_shape.get("model", 1)
    b_local = max(shape.global_batch / dp, 1.0)
    s = shape.seq_len
    hd = cfg.head_dim
    h_local = max(cfg.n_heads / tp, 1.0)
    kv_local = max(cfg.n_kv / tp, 1.0)
    per_layer = 2.0 * (b_local * s * hd) * (2 * h_local + 2 * kv_local)
    if shape.kind == "train":
        passes = 3.0
        per_micro = per_layer / n_micro * passes
        n_layers = cfg.n_layers + cfg.n_enc_layers
        if cfg.family == "griffin":
            n_layers = cfg.n_layers // 3  # only the local-attention blocks
        return per_micro * n_micro * n_layers
    if shape.kind == "prefill":
        n_layers = cfg.n_layers + cfg.n_enc_layers
        if cfg.family == "griffin":
            n_layers = cfg.n_layers // 3
        return per_layer * n_layers
    return 0.0  # decode attention is cache-read dominated; no substitution


def optimized_roofline(info: Dict[str, Any], cfg: ModelConfig,
                       shape: ShapeConfig,
                       mesh_shape: Optional[Dict[str, int]] = None
                       ) -> Optional[Dict[str, float]]:
    """Roofline with the flash-attention substitution."""
    att = info.get("attention_hbm_bytes")
    if not att:
        return None
    if mesh_shape is None:
        mesh_shape = ({"pod": 2, "data": 16, "model": 16}
                      if info.get("mesh") == "2x16x16"
                      else {"data": 16, "model": 16})
    flash = flash_attention_bytes(cfg, shape, info.get("n_micro", 1),
                                  mesh_shape)
    mem = max(info["cost"]["bytes"] - att + flash, 0.0)
    return {
        "compute_s": info["roofline"]["compute_s"],
        "memory_s": mem / HBM_BW,
        "collective_s": info["roofline"]["collective_s"],
        "attention_bytes_removed": att,
        "flash_bytes_added": flash,
    }


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) per step (global).

    For prefill we count 2*N*D (forward only); decode counts one new token
    per sequence.
    """
    n_active = _active_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch * 1
    return 2.0 * n_active * tokens


def _active_params(cfg: ModelConfig) -> float:
    """Parameters touched per token (MoE: top_k + shared + dense residual)."""
    d, hd = cfg.d_model, cfg.head_dim
    attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv) + cfg.n_heads * hd * d
    if cfg.family == "griffin":
        w = cfg.lru_width or d
        rec = 2 * d * w + w * d + 2 * w * w  # in/gate/out + a/i gates
        per_group = 2 * (rec + 3 * d * cfg.d_ff) + attn + 3 * d * cfg.d_ff
        n_groups = cfg.n_layers // 3
        tail = (cfg.n_layers - 3 * n_groups) * (rec + 3 * d * cfg.d_ff)
        body = per_group * n_groups + tail
    elif cfg.family == "xlstm":
        per_pair = 5 * d * d + (3 * d * d + 2 * d * cfg.n_heads + d * d)
        body = per_pair * (cfg.n_layers // 2)
    elif cfg.family == "encdec":
        enc = cfg.n_enc_layers * (attn + 3 * d * cfg.d_ff)
        dec = cfg.n_layers * (2 * attn + 3 * d * cfg.d_ff)
        body = enc + dec
    else:
        ff_active = 0.0
        if cfg.n_experts > 0:
            f = cfg.moe_d_ff or cfg.d_ff
            ff_active = 3 * d * f * cfg.top_k
            if cfg.dense_residual:
                ff_active += 3 * d * cfg.d_ff
            if cfg.n_shared:
                ff_active += 3 * d * f * cfg.n_shared
            ff_active += d * cfg.n_experts  # router
        else:
            ff_active = 3 * d * cfg.d_ff
        body = cfg.n_layers * (attn + ff_active)
    head = 2 * d * cfg.vocab  # embed + lm head
    return body + head


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--overrides", default=None,
                    help="JSON opt overrides, e.g. "
                         "'{\"grad_rs\":true,\"n_micro\":2}'")
    ap.add_argument("--tag", default=None,
                    help="suffix for the result key (perf iterations)")
    args = ap.parse_args()
    overrides = json.loads(args.overrides) if args.overrides else None

    archs = config_registry.ARCHS if (args.all or not args.arch) \
        else [config_registry.canonical(args.arch)]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results: Dict[str, Any] = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                cell = f"{arch}|{shape}|{'multi' if mp else 'single'}"
                if args.tag:
                    cell = f"{cell}|{args.tag}"
                if cell in results and results[cell].get("status") in (
                        "ok", "skipped") and not args.force:
                    print(f"[skip cached] {cell}")
                    continue
                print(f"[tracing] {cell}", flush=True)
                try:
                    ov = dict(overrides) if overrides else None
                    if ov is not None and args.tag:
                        ov["tag"] = args.tag
                    info = lower_cell(arch, shape, mp, opt_overrides=ov)
                except Exception as e:  # noqa: BLE001 -- record and continue
                    info = {"status": "error", "error": f"{type(e).__name__}: {e}",
                            "traceback": traceback.format_exc()[-2000:]}
                    print(f"[ERROR] {cell}: {info['error']}", flush=True)
                results[cell] = info
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
                if info.get("status") == "ok":
                    r = info["roofline"]
                    print(f"[ok] {cell} trace={info['trace_s']}s "
                          f"flops={info['cost']['flops']:.3e} "
                          f"comp={r['compute_s']:.4f}s mem={r['memory_s']:.4f}s "
                          f"coll={r['collective_s']:.4f}s -> {info['bottleneck']}",
                          flush=True)
    n_ok = sum(1 for v in results.values() if v.get("status") == "ok")
    n_skip = sum(1 for v in results.values() if v.get("status") == "skipped")
    n_err = sum(1 for v in results.values() if v.get("status") == "error")
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors")


if __name__ == "__main__":
    main()
