"""The port's sharded train step on the card: DTensor parameters on a
1-rank NCCL mesh (``make_host_mesh(1, 1)``) against the same step on plain
tensors, and the distributed tools the port relies on.

Every test here is marked ``cuda`` and skips (with its reason) where no CUDA
device is present: the flash kernel has no CPU build and NCCL needs a card.
The file imports only torch and the port, so it runs on a GPU machine that
has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_sharding_cuda.py

On a 1 x 1 mesh every DTensor holds its whole tensor, so the sharded step
must equal the plain one bit for bit, with the flash kernel launched on
each rank's local block as many times.
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch._tree import leaves
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import logical_specs
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import build_train_step
from repro_torch.runtime.steps import init_train_state
from repro_torch.sharding import shard_tree, use_rules

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _step(cfg, dev, sharded):
    opt = AdamWConfig(lr=1e-3, warmup_steps=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_train_state(cfg, opt, gen, dev)
    tokens = torch.randint(1, cfg.vocab, (4, 128), generator=gen,
                           device=dev)
    batch = {"tokens": tokens, "labels": tokens}
    before = flash_attention_fwd.launches
    if sharded:
        specs = logical_specs(cfg)
        with use_rules(make_host_mesh(1, 1, device=dev)):
            state.params = shard_tree(state.params, specs)
            from repro_torch.optim import adamw_init
            state.opt = adamw_init(opt, state.params)
            state, m = build_train_step(cfg, opt, n_micro=2,
                                        param_specs=specs)(state, batch)
            params = [p.full_tensor() for p in leaves(state.params)]
            loss = m["loss"].full_tensor()
    else:
        state, m = build_train_step(cfg, opt, n_micro=2)(state, batch)
        params, loss = leaves(state.params), m["loss"]
    torch.cuda.synchronize()
    return loss, params, flash_attention_fwd.launches - before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_step_on_one_rank_equals_the_plain_step(cuda, dtype):
    cfg = dataclasses.replace(configs.get_smoke_config("llama3_8b"),
                              d_head=64, dtype=dtype, param_dtype=dtype)
    loss0, p0, n0 = _step(cfg, cuda, sharded=False)
    loss1, p1, n1 = _step(cfg, cuda, sharded=True)
    assert n0 == n1 == 2 * cfg.n_layers * 2  # 2 micro-batches, + recompute
    assert torch.equal(loss0, loss1)
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)


def test_distributed_tools_import(cuda):
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import local_map
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.utils.flop_counter import FlopCounterMode
    assert all((MemTracker, CommDebugMode, local_map, FakeStore,
                FlopCounterMode))
