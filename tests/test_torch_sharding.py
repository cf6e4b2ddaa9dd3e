"""The port's sharding rules, logical specs, batch specs and re-mesh plan
against the JAX package's, and DTensor's layout of an axis tuple.

Spec resolution needs no devices: both packages resolve against abstract
meshes of the production shapes, (1, 1), (16, 16) and (2, 16, 16), for
every parameter leaf of every full-size architecture (shapes from
``jax.eval_shape`` and the port's meta-device init, nothing allocated),
the decode caches and the batches, under the default rules and both
presets.  The layout check spawns 4 gloo ranks (a 2 x 2 mesh) that meet
through a ``file://`` store under ``tmp_path`` and are joined within 60 s.
"""
import ast
import functools
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import AbstractMesh as JAbstractMesh

from repro import configs as jconfigs
from repro import models as jmodels
from repro.data import pipeline as jpipeline
from repro.launch import dryrun as jdryrun
from repro.runtime import elastic as jelastic
from repro.sharding import rules as jrules
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch import sharding as tsharding
from repro_torch.data import make_batch_specs
from repro_torch.launch import dryrun as tdryrun
from repro_torch.models.config import SHAPES
from repro_torch.runtime import elastic as telastic
from repro_torch.runtime import make_train_state_specs
from repro_torch.sharding import rules as trules

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
PRESETS = [None, "pod_fsdp", "pure_fsdp"]
_is_spec = lambda x: isinstance(x, tuple)  # noqa: E731


@functools.lru_cache(maxsize=None)
def _ref_init_full(arch):
    return _ref_init(jconfigs.get_config(arch))


def _ref_init(cfg):
    box = {}

    def init(key):
        p, s = jmodels.init_model(cfg, key)
        box["s"] = s
        return p

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return shapes, box["s"]


def _pairs(tree_a, tree_b):
    """(path, a, b) over two nested dicts whose leaves are tuples or
    arrays, failing where the key sets differ."""
    if isinstance(tree_a, dict):
        assert isinstance(tree_b, dict) and set(tree_a) == set(tree_b), (
            sorted(tree_a), sorted(tree_b) if isinstance(tree_b, dict)
            else tree_b)
        for k in sorted(tree_a):
            for path, a, b in _pairs(tree_a[k], tree_b[k]):
                yield (k,) + path, a, b
        return
    yield (), tree_a, tree_b


def _rules(mesh_name, preset):
    shape, names = MESHES[mesh_name]
    over_j = jdryrun.RULES_PRESETS[preset] if preset else None
    over_t = tdryrun.RULES_PRESETS[preset] if preset else None
    return (jrules.AxisRules(JAbstractMesh(shape, names), over_j),
            trules.AxisRules(trules.AbstractMesh(shape, names), over_t))


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_logical_specs_equal_the_reference(arch, size):
    full = size == "full"
    get_j = jconfigs.get_config if full else jconfigs.get_smoke_config
    get_t = tconfigs.get_config if full else tconfigs.get_smoke_config
    shapes, want = _ref_init(get_j(arch))
    got = tmodels.logical_specs(get_t(arch))
    params = tmodels.abstract_params(get_t(arch))
    n = 0
    for path, g, w in _pairs(got, want):
        assert tuple(g) == tuple(w), path
        n += 1
    for path, p, s in _pairs(params, jax.tree.map(lambda x: x, shapes)):
        assert tuple(p.shape) == tuple(s.shape), path
        assert p.device.type == "meta"
    assert n == len(jax.tree.leaves(shapes))


def test_the_port_has_the_reference_archs():
    assert tconfigs.ARCHS == jconfigs.ARCHS


@pytest.mark.parametrize("preset", PRESETS, ids=lambda p: p or "default")
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_best_spec_equals_the_reference_for_every_parameter(arch, mesh_name,
                                                            preset):
    jr, tr = _rules(mesh_name, preset)
    shapes, specs = _ref_init_full(arch)
    flat_s = jax.tree.leaves(specs, is_leaf=_is_spec)
    flat_p = jax.tree.leaves(shapes)
    assert len(flat_s) == len(flat_p)
    for p, s in zip(flat_p, flat_s):
        want = jrules.best_spec(p.shape, s, jr)
        got = trules.best_spec(p.shape, s, tr)
        assert isinstance(got, trules.PartitionSpec)
        assert tuple(got) == tuple(want), (p.shape, s)


@pytest.mark.parametrize("preset", PRESETS, ids=lambda p: p or "default")
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_cache_and_batch_specs_equal_the_reference(arch, mesh_name, preset):
    jr, tr = _rules(mesh_name, preset)
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for head in (False, True):
        want = jdryrun.cache_logical(jcfg, head_sharded=head)
        got = tdryrun.cache_logical(tcfg, head_sharded=head)
        assert got == want
    shape = SHAPES["decode_32k"]
    jcache = jax.eval_shape(lambda: jmodels.init_cache(
        jcfg, shape.global_batch, shape.seq_len))
    tcache = tmodels.init_cache(tcfg, shape.global_batch, shape.seq_len,
                                device="meta")
    logical = tdryrun.cache_logical(tcfg)
    for k, v in jcache.items():
        assert tuple(tcache[k].shape) == tuple(v.shape), k
        assert (tuple(trules.best_spec(v.shape, logical[k], tr))
                == tuple(jrules.best_spec(v.shape, logical[k], jr))), k
    for name in ("train_4k", "prefill_32k"):
        jb = jpipeline.make_batch_specs(jcfg, SHAPES[name])
        tb = make_batch_specs(tcfg, SHAPES[name])
        for k, v in jb.items():
            logical = ((None, "batch", None) if k == "positions"
                       else ("batch",) + (None,) * (len(v.shape) - 1))
            assert (tuple(trules.best_spec(tb[k].shape, logical, tr))
                    == tuple(jrules.best_spec(v.shape, logical, jr))), k


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_make_batch_specs_equals_the_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for name, shape in SHAPES.items():
        for override in (None, 4):
            want = jpipeline.make_batch_specs(jcfg, shape, override)
            got = make_batch_specs(tcfg, shape, override)
            assert set(got) == set(want), name
            for k, v in want.items():
                assert tuple(got[k].shape) == tuple(v.shape), (name, k)
                assert str(got[k].dtype).removeprefix("torch.") == str(
                    v.dtype), (name, k)
                assert got[k].device.type == "meta"


def test_train_state_specs_mirror_the_reference():
    specs = tmodels.logical_specs(tconfigs.get_smoke_config("llama3_8b"))
    st = make_train_state_specs(None, specs)
    assert st.params is specs and st.opt["m"] is specs
    assert st.opt["v"] is specs and st.opt["step"] == () and st.step == ()


def test_use_rules_nests_and_is_per_thread():
    outer = trules.AbstractMesh((16, 16), ("data", "model"))
    inner = trules.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert trules.current_rules() is None
    seen = {}

    def other():
        seen["other"] = trules.current_rules()

    with tsharding.use_rules(outer) as r1:
        assert trules.current_rules() is r1 and r1.mesh is outer
        with tsharding.use_rules(inner, {"batch": [None]}) as r2:
            assert trules.current_rules() is r2
            assert tuple(trules.best_spec((256, 8), ("batch", None))) == (
                None, None)
            t = threading.Thread(target=other)
            t.start()
            t.join()
        assert trules.current_rules() is r1
        with tsharding.use_rules(None):
            assert trules.current_rules() is None
            assert tuple(trules.best_spec((256, 8), ("batch", None))) == ()
        assert trules.current_rules() is r1
    assert seen["other"] is None
    assert trules.current_rules() is None


@pytest.mark.parametrize("storage", ["this_torch", "process_wide"])
def test_implicit_replication_holds_while_any_thread_is_inside(
        storage, monkeypatch):
    """DTensor's implicit-replication flag is one for the process in some
    torch versions and one per thread in others: either way, one thread
    leaving its ``use_rules`` must not clear it under another still
    inside, and the last to leave puts it back (a stand-in with a
    DeviceMesh's names and shape will do: the flag does not look at the
    mesh).  ``process_wide`` stands in a dispatcher whose flag is a plain
    attribute, as older torch keeps it."""
    import types
    from torch.distributed.tensor import DTensor

    class Mesh:
        mesh_dim_names, shape = ("data", "model"), (1, 1)

    monkeypatch.setitem(trules._implicit, "per_thread", None)
    if storage == "process_wide":
        monkeypatch.setattr(DTensor, "_op_dispatcher", types.SimpleNamespace(
            _allow_implicit_replication=False))
    disp = DTensor._op_dispatcher
    before = disp._allow_implicit_replication
    a_in, main_out = threading.Event(), threading.Event()
    seen = {}

    def a():
        with tsharding.use_rules(Mesh()):
            a_in.set()
            main_out.wait(10)
            seen["a_after_main_left"] = disp._allow_implicit_replication

    with tsharding.use_rules(Mesh()):  # in first, out first
        assert disp._allow_implicit_replication
        t = threading.Thread(target=a)
        t.start()
        a_in.wait(10)
    main_out.set()
    t.join()
    assert seen["a_after_main_left"] is True
    assert disp._allow_implicit_replication == before
    if storage == "process_wide":
        assert trules._implicit["per_thread"] is False


def test_logical_shard_leaves_plain_tensors_alone():
    x = torch.ones(4, 8)
    assert tsharding.logical_shard(x, "batch", None) is x
    mesh = trules.AbstractMesh((2, 2), ("data", "model"))
    with tsharding.use_rules(mesh):
        assert tsharding.logical_shard(x, "batch", None) is x


def test_placements_of_axis_tuples():
    from torch.distributed.tensor import Replicate, Shard
    mesh = trules.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    got = trules.placements(trules.PartitionSpec(("pod", "data"), "model"),
                            mesh)
    assert got == (Shard(0), Shard(0), Shard(1))
    assert trules.placements(trules.PartitionSpec(None, None), mesh) == (
        Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        trules.placements(trules.PartitionSpec(("model", "data")), mesh)


@pytest.mark.parametrize("n_healthy", [0, 1, 3, 4, 15, 16, 17, 100, 255,
                                       256, 300, 400, 511, 512, 1000])
@pytest.mark.parametrize("model_parallel", [1, 2, 8, 16])
def test_plan_remesh_equals_the_reference(n_healthy, model_parallel):
    want = jelastic.plan_remesh(n_healthy, model_parallel)
    got = telastic.plan_remesh(n_healthy, model_parallel)
    if want is None:
        assert got is None
        return
    assert (got.mesh_shape, got.axis_names, got.dropped_hosts,
            got.global_batch_scale) == (want.mesh_shape, want.axis_names,
                                        want.dropped_hosts,
                                        want.global_batch_scale)


def _layout_rank(rank, tmp):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=4)
    try:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(2, 2, device="cpu")
        x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
        out = {}
        with tsharding.use_rules(mesh, {"batch": [("data", "model")]}):
            spec = trules.best_spec(x.shape, ("batch", None))
            d = tsharding.distribute(x, spec, mesh)
            out["tuple"] = d.to_local().numpy()
            rep = tsharding.distribute(x, trules.PartitionSpec(), mesh)
            out["constrained"] = tsharding.logical_shard(
                rep, "batch", None).to_local().numpy()
        coord = mesh.get_coordinate()
        np.savez(f"{tmp}/rank{rank}.npz", coord=np.asarray(coord), **out)
    finally:
        dist.destroy_process_group()


def test_axis_tuple_gives_each_rank_the_jax_block(tmp_path):
    """A dim sharded over ("data", "model") on a 2 x 2 DeviceMesh: rank
    (d, m) holds rows [2 (2 d + m), 2 (2 d + m) + 2), data major, as JAX
    lays out ``PartitionSpec(("data", "model"))``; and ``logical_shard``
    redistributes a replicated DTensor to the same blocks."""
    ctx = mp.start_processes(_layout_rank, args=(str(tmp_path),), nprocs=4,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + 60
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError("ranks still running after 60 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    for rank in range(4):
        got = np.load(tmp_path / f"rank{rank}.npz")
        d, m = got["coord"]
        block = x[2 * (2 * d + m):2 * (2 * d + m) + 2]
        np.testing.assert_array_equal(got["tuple"], block)
        np.testing.assert_array_equal(got["constrained"], block)


def test_examples_and_chip_smoke_import_no_jax_or_reference():
    files = sorted((ROOT / "examples_torch").glob("*.py"))
    files += sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert ROOT / "examples_torch" / "train_lm.py" in files
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (
                    f"{path}: imports {name}")
