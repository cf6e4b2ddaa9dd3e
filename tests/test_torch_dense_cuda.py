"""The port's dense family on the card: the flash kernel at Llama-3-8B's
attention shapes, a full-width model against the same weights on the CPU,
and which calls launch the kernel.

Every test here is marked ``cuda`` and skips (with its reason) where no CUDA
device is present: a CUDA kernel has no CPU build.  The file imports only
torch and the port, so it runs on a GPU machine that has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_dense_cuda.py

Tolerances: flash attention 2e-2 elementwise and 5e-3 normwise in bf16
(the reference's ``tests/test_kernels.py`` bar and the port's normwise
one); the bf16 model on the card against the CPU 2e-2 normwise per output
(another attention kernel, another matmul library, bf16 activations).
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch import models
from repro_torch._tree import tree_map
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import build_train_step
from repro_torch.runtime.steps import init_train_state

FLASH_TOL = 2e-2
FLASH_NORM_TOL = 5e-3
MODEL_NORM_TOL = 2e-2

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _normwise(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


@pytest.mark.parametrize("s", [130, 1000, 4096])
def test_flash_kernel_at_llama3_8b_heads(cuda, s):
    """32 q heads over 8 kv heads of 128, causal, no window: a group of 4
    q heads a kv head, and a ragged last tile at S = 130 and 1000."""
    g = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = [torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
               for shape in ((1, 32, s, 128), (1, 8, s, 128),
                             (1, 8, s, 128))]
    before = flash_attention_fwd.launches
    got = flash_attention_fwd(q, k, v, causal=True, window=0)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    want = ref.attention_ref(q, k, v, causal=True, window=0)
    torch.testing.assert_close(got.float(), want.float(), atol=FLASH_TOL,
                               rtol=FLASH_TOL)
    assert _normwise(got, want) <= FLASH_NORM_TOL
    # a wrong kv head for any q head of a group moves the output far off
    wrong = ref.attention_ref(q, k.roll(1, dims=1), v.roll(1, dims=1))
    assert _normwise(got, wrong) > 0.1


def test_full_width_llama3_8b_on_the_card_matches_the_cpu(cuda):
    """Two layers of Llama-3-8B at full width in bf16: forward logits and
    prefill's last logits and caches on the card (flash kernel) against the
    same weights on the CPU (plain attention)."""
    cfg = dataclasses.replace(configs.get_config("llama3-8b"), n_layers=2)
    cpu = models.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    dev = tree_map(lambda t: t.to(cuda), cpu)
    toks = torch.randint(0, cfg.vocab, (1, 256),
                         generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        want, _ = models.forward(cpu, cfg, toks)
        got, _ = models.forward(dev, cfg, toks.to(cuda))
        assert bool(torch.isfinite(got).all())
        assert _normwise(got, want) <= MODEL_NORM_TOL
        del want, got
        wl, wc = models.prefill(cpu, cfg, toks, max_len=264)
        gl, gc = models.prefill(dev, cfg, toks.to(cuda), max_len=264)
    assert _normwise(gl, wl) <= MODEL_NORM_TOL
    for key in ("k", "v"):
        assert _normwise(gc[key], wc[key]) <= MODEL_NORM_TOL, key
    assert int(gc["index"]) == int(wc["index"]) == 256


def _smoke(arch: str, **kw):
    """The smoke config with a head dim the kernel takes (64)."""
    return dataclasses.replace(configs.get_smoke_config(arch), d_head=64,
                               **kw)


def test_prefill_launches_the_kernel_once_a_layer_and_decode_never(cuda):
    cfg = _smoke("llama3-8b")
    params = models.init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                               cuda)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=cuda)
    before = flash_attention_fwd.launches
    logits, cache = models.prefill(params, cfg, toks[:, :36], max_len=40)
    assert flash_attention_fwd.launches == before + cfg.n_layers
    for t in range(36, 39):
        logits, cache = models.decode_step(params, cfg, cache,
                                           toks[:, t:t + 1])
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + cfg.n_layers
    assert bool(torch.isfinite(logits).all())


def test_remat_train_step_launches_the_kernel_four_times_a_layer(cuda):
    """Forward and remat's recompute in each of 2 micro-batches."""
    cfg = _smoke("llama3-8b", n_layers=3)
    opt = AdamWConfig(lr=1e-3, warmup_steps=0)
    state = init_train_state(cfg, opt,
                             torch.Generator(device=cuda).manual_seed(0), cuda)
    toks = torch.randint(0, cfg.vocab, (4, 64), device=cuda)
    before = flash_attention_fwd.launches
    state, metrics = build_train_step(cfg, opt, n_micro=2)(
        state, {"tokens": toks, "labels": toks})
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 4 * cfg.n_layers
    assert bool(torch.isfinite(metrics["loss"]))


def test_mrope_positions_take_the_plain_attention(cuda):
    """Qwen2-VL with explicit (3, B, S) M-RoPE positions runs
    ``chunked_attention`` (as the JAX package always does); with default
    positions a fresh prompt takes the kernel."""
    cfg = _smoke("qwen2-vl-72b", mrope_sections=(16, 8, 8))
    params = models.init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                               cuda)
    toks = torch.randint(0, cfg.vocab, (2, 32), device=cuda)
    pos = torch.arange(32, device=cuda).expand(3, 2, 32)
    before = flash_attention_fwd.launches
    with torch.inference_mode():
        explicit, _ = models.forward(params, cfg, toks, positions=pos)
        assert flash_attention_fwd.launches == before
        default, _ = models.forward(params, cfg, toks)
    assert flash_attention_fwd.launches == before + cfg.n_layers
    # text positions on all three streams are the default positions
    assert _normwise(explicit, default) <= MODEL_NORM_TOL
