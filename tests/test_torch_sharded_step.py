"""The port's sharded steps on a 2 x 2 DeviceMesh over 4 gloo ranks,
against the JAX package's unsharded steps.

The reference's own sharded step fails on this jax (ROADMAP C2, C6), so the
port's sharded step is held against the reference's unsharded one, from the
same weights (the JAX init's, carried over with ``params_from_jax``) and
the same batch, in float32: the loss within 1e-5 relative, each parameter
leaf's gradient (the first AdamW moment, 0.1 x the clipped gradient) within
1e-5 normwise, the parameters within the reference's own bound for
Adam's sign-like first step (2.6 x lr, ``tests/test_runtime.py``), and
each leaf's update p1 - p0 within 1e-3 normwise of the reference's (an
element whose gradient is near zero may take Adam's step the other way,
which the elementwise bound allows and the normwise one caps).  The train
step runs for the dense, MoE (dispatch both ways), griffin and xLSTM smoke
configs, and under ``remat_policy="dots"`` for the dense and griffin ones
(the reference's ``"dots"`` step; the gathers rerun in the recompute, the
saved products are DTensors).  Prefill and two decode steps (dense, MoE,
griffin and xLSTM smoke configs) are held at 1e-5.  Each rank's block is
gathered (``full_tensor``) for the comparison; ``CommDebugMode`` shows the
collectives each step ran.  Each case spawns its 4 ranks afresh and joins
them within 60 s; the ranks meet through a ``file://`` store under the
test's ``tmp_path``.
"""
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro import configs as jconfigs
from repro import models as jmodels
from repro import optim as joptim
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.runtime import steps as jsteps

WORLD = 4
JOIN_S = 60
LR = 1e-3
UPDATE_TOL = 1e-3  # normwise, on p1 - p0 (worst leaf seen: 3.2e-4)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, dtype=np.float32)
    return out


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def _port_cfg(spec):
    from repro_torch import configs as tconfigs
    return dataclasses.replace(
        tconfigs.get_smoke_config(spec["arch"]), dtype=torch.float32,
        param_dtype=torch.float32, moe_ep_dispatch=spec.get("ep", False),
        remat_policy=spec.get("policy", "nothing"))


def _comm_counts(cm):
    return {str(k).split(".")[-1]: int(v)
            for k, v in cm.get_comm_counts().items()}


def _case_train(spec, tmp):
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import logical_specs, params_from_jax
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.steps import TrainState, build_train_step
    from repro_torch.sharding import shard_tree, use_rules
    cfg = _port_cfg(spec)
    data = np.load(f"{tmp}/in.npz")
    params = params_from_jax(_unflatten(
        {k[2:]: data[k] for k in data.files if k.startswith("p:")}),
        cfg, "cpu")
    batch = {k: torch.as_tensor(data[k]) for k in ("tokens", "labels")}
    opt = AdamWConfig(lr=LR, warmup_steps=0)
    specs = logical_specs(cfg)
    with use_rules(make_host_mesh(2, 2, device="cpu")):
        dp = shard_tree(params, specs)
        state = TrainState(dp, adamw_init(opt, dp),
                           torch.zeros((), dtype=torch.int32))
        step = build_train_step(cfg, opt, n_micro=2, param_specs=specs)
        with CommDebugMode() as cm:
            state, metrics = step(state, batch)
        out = {f"p:{k}": v
               for k, v in _flatten(_tree_full(state.params)).items()}
        out.update({f"m:{k}": v for k, v in
                    _flatten(_tree_full(state.opt["m"])).items()})
        for k in ("loss", "aux", "grad_norm"):
            out[k] = np.asarray(float(metrics[k]))
    return out, _comm_counts(cm)


def _tree_full(tree):
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: _tree_full(v) for k, v in tree.items()}
    t = tree.full_tensor() if isinstance(tree, DTensor) else tree
    return t.detach().float().numpy()


def _case_serve(spec, tmp):
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import (decode_step, logical_specs,
                                    params_from_jax, prefill)
    from repro_torch.sharding import shard_tree, use_rules
    cfg = _port_cfg(spec)
    data = np.load(f"{tmp}/in.npz")
    params = params_from_jax(_unflatten(
        {k[2:]: data[k] for k in data.files if k.startswith("p:")}),
        cfg, "cpu")
    toks = torch.as_tensor(data["tokens"])
    s = toks.shape[1] - 2

    def full(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).numpy()

    with use_rules(make_host_mesh(2, 2, device="cpu")):
        dp = shard_tree(params, logical_specs(cfg))
        with CommDebugMode() as cm:
            logits, cache = prefill(dp, cfg, toks[:, :s], max_len=s + 2)
            out = {"prefill": full(logits)}
            for t in range(s, s + 2):
                logits, cache = decode_step(dp, cfg, cache, toks[:, t:t + 1])
                out[f"decode{t - s}"] = full(logits)
    return out, _comm_counts(cm)


def _case_elastic(spec, tmp):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime.elastic import FaultTolerantRunner
    mgr = CheckpointManager(f"{tmp}/ckpt", async_save=False)
    like = {"w": torch.zeros(4)}
    runner = FaultTolerantRunner(mgr, model_parallel=2, device="cpu")
    mesh, got, step, decision = runner.on_failure(list(range(WORLD)), like)
    return {"w": got["w"].numpy(), "step": np.asarray(step),
            "mesh": np.asarray(mesh.shape),
            "shape": np.asarray(decision.mesh_shape)}, {}


CASES = {"train": _case_train, "serve": _case_serve,
         "elastic": _case_elastic}


def _rank(rank, tmp, case, spec):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=WORLD)
    try:
        out, comms = CASES[case](spec, tmp)
        if rank == 0:
            np.savez(f"{tmp}/out.npz", **out)
            with open(f"{tmp}/comms.json", "w") as f:
                json.dump(comms, f)
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, case, spec):
    ctx = mp.start_processes(_rank, args=(str(tmp_path), case, spec),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{case}: ranks still running after "
                                   f"{JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = dict(np.load(tmp_path / "out.npz"))
    with open(tmp_path / "comms.json") as f:
        return out, json.load(f)


def _jcfg(arch, ep=False, policy="nothing"):
    return dataclasses.replace(jconfigs.get_smoke_config(arch),
                               dtype=jnp.float32, param_dtype=jnp.float32,
                               moe_ep_dispatch=ep, remat_policy=policy)


def _inputs(tmp_path, jparams, tokens):
    flat = {f"p:{k}": v for k, v in _flatten(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)).items()}
    np.savez(tmp_path / "in.npz", tokens=tokens, labels=tokens, **flat)


def _normwise(got, want) -> float:
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("arch,ep,policy", [
    ("llama3_8b", False, "nothing"), ("qwen2_moe_a2_7b", False, "nothing"),
    ("qwen2_moe_a2_7b", True, "nothing"),
    ("recurrentgemma_2b", False, "nothing"), ("xlstm_125m", False, "nothing"),
    ("llama3_8b", False, "dots"), ("recurrentgemma_2b", False, "dots")],
    ids=["dense", "moe", "moe-ep-dispatch", "griffin", "xlstm", "dense-dots",
         "griffin-dots"])
def test_sharded_train_step_matches_the_unsharded_reference(tmp_path, arch,
                                                             ep, policy):
    jcfg = _jcfg(arch, ep, policy)
    jopt = joptim.AdamWConfig(lr=LR, warmup_steps=0)
    jstate, _ = jsteps.init_train_state(jcfg, jopt, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(3).integers(
        1, jcfg.vocab, (4, 16)).astype(np.int32)
    _inputs(tmp_path, jstate.params, tokens)
    got, comms = _spawn(tmp_path, "train",
                        {"arch": arch, "ep": ep, "policy": policy})
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
    js, jm = jax.jit(jsteps.build_train_step(jcfg, jopt, n_micro=2))(jstate,
                                                                    jb)
    np.testing.assert_allclose(got["loss"], np.asarray(jm["loss"]),
                               rtol=1e-5, err_msg="loss")
    np.testing.assert_allclose(got["grad_norm"], np.asarray(jm["grad_norm"]),
                               rtol=1e-5, err_msg="grad_norm")
    np.testing.assert_allclose(got["aux"], np.asarray(jm["aux"]), rtol=1e-5,
                               atol=1e-7, err_msg="aux")
    want_p = _flatten(jax.tree.map(np.asarray, js.params))
    want_m = _flatten(jax.tree.map(np.asarray, js.opt["m"]))
    assert {k[2:] for k in got if k.startswith("p:")} == set(want_p)
    p0 = _flatten(jax.tree.map(np.asarray, jstate.params))
    for k in want_p:
        assert _normwise(got[f"m:{k}"], want_m[k]) <= 1e-5, k
        np.testing.assert_allclose(got[f"p:{k}"], want_p[k], atol=2.6 * LR,
                                   err_msg=k)
        # the update itself: a step left undone, or any update off by a
        # sizeable part of lr, reads ~1 here
        assert _normwise(got[f"p:{k}"] - p0[k],
                         want_p[k] - p0[k]) <= UPDATE_TOL, k
    # the step sharded: gathers for FSDP and TP, and gradients reduced
    assert comms.get("all_gather_into_tensor", 0) > 0, comms
    assert comms.get("reduce_scatter_tensor", 0) > 0, comms


@pytest.mark.parametrize("arch", ["llama3_8b", "qwen2_moe_a2_7b",
                                  "recurrentgemma_2b", "xlstm_125m"])
def test_sharded_prefill_and_decode_match_the_unsharded_reference(tmp_path,
                                                                  arch):
    jcfg = _jcfg(arch)
    jparams, _ = jmodels.init_model(jcfg, jax.random.PRNGKey(1))
    tokens = np.random.default_rng(4).integers(
        1, jcfg.vocab, (4, 14)).astype(np.int32)
    _inputs(tmp_path, jparams, tokens)
    got, comms = _spawn(tmp_path, "serve", {"arch": arch})
    s = tokens.shape[1] - 2
    jt = jnp.asarray(tokens)
    logits, cache = jax.jit(lambda p, t: jmodels.prefill(
        p, jcfg, t, max_len=s + 2))(jparams, jt[:, :s])
    np.testing.assert_allclose(got["prefill"], np.asarray(logits),
                               rtol=1e-5, atol=1e-5, err_msg="prefill")
    step = jax.jit(lambda p, c, t: jmodels.decode_step(p, jcfg, c, t))
    for i, t in enumerate(range(s, s + 2)):
        logits, cache = step(jparams, cache, jt[:, t:t + 1])
        np.testing.assert_allclose(got[f"decode{i}"], np.asarray(logits),
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"decode {i}")
    assert comms.get("all_gather_into_tensor", 0) > 0, comms


def test_fault_tolerant_runner_remeshes_and_resumes(tmp_path):
    """``tests/test_runtime.py``'s end-to-end recovery on the port: a
    checkpoint of step 3 (written by the JAX package's manager, which the
    port's restores), then ``on_failure`` with all 4 ranks healthy and a
    model axis of 2: a (2, 2) mesh over the ranks, the state back."""
    want = np.arange(4.0, dtype=np.float32)
    JCheckpointManager(str(tmp_path / "ckpt"), async_save=False).save(
        3, {"w": jnp.asarray(want)})
    got, _ = _spawn(tmp_path, "elastic", {})
    assert int(got["step"]) == 3
    np.testing.assert_array_equal(got["w"], want)
    assert tuple(got["mesh"]) == tuple(got["shape"]) == (2, 2)
