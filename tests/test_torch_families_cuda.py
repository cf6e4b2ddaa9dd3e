"""The port's moe, xlstm and encdec families on the card: each smoke config
on the card (the flash kernel, a head dim it takes) against the same
weights on the card's host (the plain attention), and which calls launch
the kernel.

Every test here is marked ``cuda`` and skips (with its reason) where no CUDA
device is present: a CUDA kernel has no CPU build.  The file imports only
torch and the port, so it runs on a GPU machine that has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_families_cuda.py

Tolerances: the moe family runs in float32 and is held at 1e-4 normwise
(the float32 flash kernel is held at 2e-5 elementwise, and float32 keeps
the router's choices where bf16 noise could flip a near tie); the xlstm
and encdec families run in bf16 at 2e-2 normwise per output (another
attention kernel, another matmul library, bf16 activations).
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch import models
from repro_torch._tree import leaves, tree_map
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import build_train_step
from repro_torch.runtime.steps import init_train_state

F32_NORM_TOL = 1e-4
BF16_NORM_TOL = 2e-2

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _normwise(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want||; the absolute difference where ``want``
    is zero (the mLSTM's m after prefill)."""
    got, want = got.float().cpu(), want.float().cpu()
    diff = float(torch.linalg.vector_norm(got - want))
    scale = float(torch.linalg.vector_norm(want))
    return diff / scale if scale else diff


def _smoke(arch: str, **kw):
    """The smoke config; attention families get a head dim the kernel
    takes (64)."""
    cfg = configs.get_smoke_config(arch)
    if cfg.family != "xlstm":
        kw = dict(kw, d_head=64)
    return dataclasses.replace(cfg, **kw)


def _frames(cfg, b: int, s: int, device="cpu"):
    if cfg.family != "encdec":
        return None
    g = torch.Generator().manual_seed(5)
    return torch.randn((b, s // cfg.enc_frames_ratio, cfg.d_model),
                       generator=g).to(device)


CASES = {"qwen2-moe-a2.7b": (torch.float32, F32_NORM_TOL),
         "arctic-480b": (torch.float32, F32_NORM_TOL),
         "xlstm-125m": (torch.bfloat16, BF16_NORM_TOL),
         "whisper-small": (torch.bfloat16, BF16_NORM_TOL)}


@pytest.mark.parametrize("arch", sorted(CASES))
def test_smoke_model_on_the_card_matches_the_host(cuda, arch):
    """Forward logits, prefill's last logits and caches, and 3 decode
    steps: the card against the same weights on the host."""
    dtype, tol = CASES[arch]
    cfg = _smoke(arch, dtype=dtype, param_dtype=dtype)
    cpu = models.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    dev = tree_map(lambda t: t.to(cuda), cpu)
    s = 256
    toks = torch.randint(0, cfg.vocab, (2, s + 3),
                         generator=torch.Generator().manual_seed(1))
    fr = _frames(cfg, 2, s)
    fr_dev = None if fr is None else fr.to(cuda)
    with torch.inference_mode():
        want, want_aux = models.forward(cpu, cfg, toks[:, :s], frames=fr)
        got, aux = models.forward(dev, cfg, toks[:, :s].to(cuda),
                                  frames=fr_dev)
        assert bool(torch.isfinite(got).all())
        assert _normwise(got, want) <= tol
        if cfg.family == "moe":
            assert abs(float(aux) - float(want_aux)) <= 1e-4 * float(want_aux)
    wl, wc = models.prefill(cpu, cfg, toks[:, :s], frames=fr, max_len=s + 4)
    gl, gc = models.prefill(dev, cfg, toks[:, :s].to(cuda), frames=fr_dev,
                            max_len=s + 4)
    assert _normwise(gl, wl) <= tol
    for key in wc:
        if key != "index":
            assert _normwise(gc[key], wc[key]) <= tol, key
    for t in range(s, s + 3):
        wl, wc = models.decode_step(cpu, cfg, wc, toks[:, t:t + 1])
        gl, gc = models.decode_step(dev, cfg, gc, toks[:, t:t + 1].to(cuda))
        assert _normwise(gl, wl) <= tol, t


def _recording(monkeypatch):
    """The causal flag of every ``ops.flash_attention`` call."""
    flags = []
    real = ops.flash_attention

    def recorded(q, k, v, causal=True, window=0):
        flags.append(bool(causal))
        return real(q, k, v, causal, window)

    monkeypatch.setattr(ops, "flash_attention", recorded)
    return flags


def test_encdec_prefill_launches_the_encoder_bidirectional(cuda, monkeypatch):
    """Whisper's prefill: one bidirectional launch an encoder layer over the
    frames, one causal launch a decoder layer over the prompt; the
    cross-attention and decode launch none."""
    cfg = _smoke("whisper-small")
    params = models.init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                               cuda)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=cuda)
    fr = _frames(cfg, 2, 36, cuda)
    flags = _recording(monkeypatch)
    before = flash_attention_fwd.launches
    logits, cache = models.prefill(params, cfg, toks[:, :36], frames=fr,
                                   max_len=40)
    assert flags == [False] * cfg.n_enc_layers + [True] * cfg.n_layers
    assert flash_attention_fwd.launches == before + cfg.n_enc_layers \
        + cfg.n_layers
    assert tuple(cache["enc_out"].shape) == (2, 9, cfg.d_model)
    for t in range(36, 39):
        logits, cache = models.decode_step(params, cfg, cache,
                                           toks[:, t:t + 1])
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + cfg.n_enc_layers \
        + cfg.n_layers
    assert bool(torch.isfinite(logits).all())


def test_xlstm_launches_no_kernel(cuda):
    cfg = _smoke("xlstm-125m")
    params = models.init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                               cuda)
    toks = torch.randint(0, cfg.vocab, (2, 512), device=cuda)
    before = flash_attention_fwd.launches
    logits, cache = models.prefill(params, cfg, toks, max_len=520)
    logits, cache = models.decode_step(params, cfg, cache, toks[:, :1])
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "whisper-small",
                                  "xlstm-125m"])
def test_remat_train_step_on_the_card(cuda, arch):
    """2 micro-batches through ``build_train_step``: flash launched in the
    forward and in remat's recompute (4 a self-attention layer a step),
    every leaf a non-zero gradient, the moe aux loss non-zero."""
    cfg = _smoke(arch)
    opt = AdamWConfig(lr=1e-3, warmup_steps=0)
    state = init_train_state(cfg, opt,
                             torch.Generator(device=cuda).manual_seed(0), cuda)
    toks = torch.randint(0, cfg.vocab, (4, 64), device=cuda)
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "encdec":
        batch["frames"] = _frames(cfg, 4, 64, cuda)
    before = flash_attention_fwd.launches
    state, metrics = build_train_step(cfg, opt, n_micro=2)(state, batch)
    torch.cuda.synchronize()
    n_attn = {"moe": cfg.n_layers, "xlstm": 0,
              "encdec": cfg.n_enc_layers + cfg.n_layers}[cfg.family]
    assert flash_attention_fwd.launches == before + 4 * n_attn
    assert bool(torch.isfinite(metrics["loss"]))
    assert (float(metrics["aux"]) > 0) == (cfg.family == "moe")
    for m in leaves(state.opt["m"]):
        assert float(m.norm()) > 0
