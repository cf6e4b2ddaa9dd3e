"""The port's flash-attention and RG-LRU kernels and its griffin prefill, on
the card.

Every test here is marked ``cuda`` and skips (with its reason) where no CUDA
device is present: a CUDA kernel has no CPU build.  The file imports only
numpy, torch and the port, so it runs on a GPU machine that has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_models_cuda.py

Tolerances: flash attention 2e-5 in float32 and 2e-2 in bfloat16, RG-LRU
1e-4 (the reference's own, ``tests/test_kernels.py``), and bf16 flash also
5e-3 normwise (``||got - want|| / ||want||``); the model on the card
against the same weights on the CPU 1e-4 in float32 (another attention
order, another matmul library) and 2e-2 in bfloat16.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch import models
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.rg_lru import rg_lru_pallas

FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
FLASH_NORM_TOL = 5e-3  # bf16, ||got - want|| / ||want||
RG_LRU_TOL = 1e-4

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(seed, b, h, hkv, s, d, dtype, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=device).to(dtype)
            for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]


@pytest.mark.parametrize("b,h,hkv,s,d,dtype,causal,window", [
    (2, 4, 4, 256, 64, torch.float32, True, 0),
    (2, 4, 1, 256, 64, torch.float32, True, 0),
    (2, 4, 4, 256, 128, torch.float32, True, 0),
    (2, 4, 1, 256, 128, torch.float32, True, 0),
    (1, 4, 1, 1024, 128, torch.bfloat16, True, 256),
    (1, 2, 2, 256, 64, torch.float32, False, 0),
    (1, 2, 1, 200, 64, torch.float32, False, 50),
    (1, 10, 1, 1000, 256, torch.bfloat16, True, 0),
    (1, 10, 1, 1000, 256, torch.float32, True, 300),
    (4, 10, 1, 4064, 256, torch.bfloat16, True, 2048),
    # the bf16 tensor-core kernel's edges: head dims 64 and 128, S shorter
    # than and just past one 128-row q tile, windows inside one tile, one kv
    # head per q head, bidirectional with and without a window
    (2, 4, 1, 256, 64, torch.bfloat16, True, 0),
    (2, 4, 1, 256, 128, torch.bfloat16, True, 0),
    (1, 4, 1, 37, 256, torch.bfloat16, True, 0),
    (1, 4, 1, 130, 128, torch.bfloat16, True, 0),
    (1, 2, 1, 300, 64, torch.bfloat16, True, 1),
    (1, 2, 1, 300, 256, torch.bfloat16, True, 63),
    (1, 4, 4, 512, 256, torch.bfloat16, True, 0),
    (1, 2, 1, 200, 64, torch.bfloat16, False, 50),
    (1, 4, 2, 333, 256, torch.bfloat16, False, 100),
    (1, 2, 2, 256, 128, torch.bfloat16, False, 0),
    # the D <= 128 design's edges: GQA 4:1 and 1:1 at the serving lengths,
    # S around its 128-key tiles, windows of 1 and of one tile, each
    # consumer warpgroup's 64 rows alone masked out of a tile (window 64:
    # rows 192-255 see no key of tile 0, rows 128-191 do), bidirectional
    # with and without a window, and Whisper's D = 64 shapes
    (1, 8, 2, 4064, 128, torch.bfloat16, True, 0),
    (1, 8, 2, 4088, 128, torch.bfloat16, True, 0),
    (1, 4, 4, 4064, 128, torch.bfloat16, True, 0),
    (1, 4, 4, 4088, 128, torch.bfloat16, True, 0),
    (1, 4, 2, 127, 128, torch.bfloat16, True, 0),
    (1, 4, 2, 128, 128, torch.bfloat16, True, 0),
    (1, 4, 2, 129, 128, torch.bfloat16, True, 0),
    (1, 4, 2, 255, 128, torch.bfloat16, True, 0),
    (1, 4, 2, 129, 64, torch.bfloat16, True, 0),
    (1, 2, 1, 600, 128, torch.bfloat16, True, 1),
    (1, 2, 1, 600, 128, torch.bfloat16, True, 127),
    (1, 2, 1, 600, 128, torch.bfloat16, True, 128),
    (1, 2, 1, 256, 128, torch.bfloat16, True, 64),
    (1, 2, 1, 384, 64, torch.bfloat16, True, 64),
    (1, 4, 2, 300, 128, torch.bfloat16, False, 0),
    (1, 4, 2, 300, 128, torch.bfloat16, False, 130),
    (1, 4, 2, 300, 64, torch.bfloat16, False, 130),
    (1, 12, 12, 1016, 64, torch.bfloat16, False, 0),
    (1, 12, 12, 4064, 64, torch.bfloat16, True, 0),
])
def test_flash_kernel_matches_plain(cuda, b, h, hkv, s, d, dtype, causal,
                                    window):
    q, k, v = _qkv(s + d, b, h, hkv, s, d, dtype, cuda)
    before = flash_attention_fwd.launches
    got = flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    assert got.dtype == dtype
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        err = float(torch.linalg.vector_norm(got.float() - want.float())
                    / torch.linalg.vector_norm(want.float()))
        assert err <= FLASH_NORM_TOL, f"normwise err {err}"


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(0, 1, 2, 1, 64, 32, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_fwd(q, k, v)
    q, k, v = _qkv(0, 1, 2, 1, 64, 64, torch.float16, cuda)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_fwd(q, k, v)


def test_flash_kernel_reads_views_off_16_byte_boundaries(cuda):
    # a contiguous bf16 view one value into its storage, which TMA cannot
    # read in place, still launches the kernel
    q, k, v = _qkv(0, 1, 2, 1, 65, 64, torch.bfloat16, cuda)
    q = q.reshape(-1)[1:1 + 2 * 64 * 64].reshape(1, 2, 64, 64)
    k, v = k[:, :, :64].contiguous(), v[:, :, :64].contiguous()
    assert q.data_ptr() % 16
    before = flash_attention_fwd.launches
    got = flash_attention_fwd(q, k, v)
    assert flash_attention_fwd.launches == before + 1
    want = ref.attention_ref(q, k, v)
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _gates(seed, shape, device):
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.sigmoid(torch.randn(shape, generator=g, device=device)) \
        * 0.3 + 0.65
    return a, torch.randn(shape, generator=g, device=device)


# W a multiple of 32 but not of 128, and ragged on both axes (S = 65 is one
# 64-step tile and one step; W = 33 one warp and one column)
@pytest.mark.parametrize("b,s,w", [(2, 512, 1024), (4, 4064, 2560),
                                   (1, 37, 300), (3, 4064, 2560),
                                   (2, 65, 33)])
def test_rg_lru_kernel_matches_plain(cuda, b, s, w):
    a, x = _gates(s + w, (b, s, w), cuda)
    before = rg_lru_pallas.launches
    got = rg_lru_pallas(a, x)
    torch.cuda.synchronize()
    assert rg_lru_pallas.launches == before + 1
    want = ref.rg_lru_ref(a, x)
    torch.testing.assert_close(got, want, atol=RG_LRU_TOL, rtol=RG_LRU_TOL)
    # one thread walks each column with a separately rounded multiply and
    # add, as the plain loop does
    assert torch.equal(got, want)


def test_rg_lru_kernel_reads_views_off_16_byte_boundaries(cuda):
    # contiguous views one float into their storage take 4-byte copies
    a, x = _gates(11, (2 * 96 * 128 + 1,), cuda)
    a = a[1:].view(2, 96, 128)
    x = x[1:].view(2, 96, 128)
    assert a.data_ptr() % 16 and x.data_ptr() % 16
    got = rg_lru_pallas(a, x)
    assert torch.equal(got, ref.rg_lru_ref(a, x))


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_smoke_prefill_and_decode_on_the_card_match_the_cpu(cuda, dtype, tol):
    # head dim 64 (the smoke config's 16 is below the kernel's 64/128/256)
    cfg = dataclasses.replace(configs.get_smoke_config("recurrentgemma-2b"),
                              d_head=64, n_layers=8, dtype=dtype,
                              param_dtype=dtype)
    cpu = models.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    dev = _to(cpu, cuda)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 27)))
    s = 24  # longer than the window of 16
    counts = (flash_attention_fwd.launches, rg_lru_pallas.launches)
    want, wc = models.prefill(cpu, cfg, toks[:, :s], max_len=s + 4)
    got, gc = models.prefill(dev, cfg, toks[:, :s].to(cuda), max_len=s + 4)
    assert (flash_attention_fwd.launches - counts[0],
            rg_lru_pallas.launches - counts[1]) == (2, 6)
    torch.testing.assert_close(got.cpu(), want, atol=tol, rtol=tol)
    for t in range(s, s + 3):
        want, wc = models.decode_step(cpu, cfg, wc, toks[:, t:t + 1])
        got, gc = models.decode_step(dev, cfg, gc, toks[:, t:t + 1].to(cuda))
        torch.testing.assert_close(got.cpu(), want, atol=tol, rtol=tol)
    for key in wc:
        torch.testing.assert_close(gc[key].cpu().float(), wc[key].float(),
                                   atol=tol, rtol=tol)
