"""Model assembly: init / forward + loss / prefill / decode (the dense and
griffin families).

Families:
  dense   -- pre-norm GQA transformer (llama3/qwen3/internlm2/starcoder2,
             qwen2-vl backbone with M-RoPE)
  griffin -- RecurrentGemma: repeating (RG-LRU, RG-LRU, local attention)
             groups, every temporal block followed by an MLP, and a tail of
             RG-LRU sublayers when the layer count is not a multiple of 3

The JAX package's ``models/model.py`` op for op; parameters keep its tree,
with the per-layer weights of ``layers`` (dense), ``groups`` and ``tail``
(griffin) stacked on a leading axis, and its ``lax.scan`` over layers is a
Python loop.  With ``cfg.remat`` the training forward recomputes each layer
(dense) or each group and tail layer (griffin) in the backward pass
(``torch.utils.checkpoint``, nothing saved inside, as the JAX package's
``nothing_saveable``).  Serving runs without autograd; caches are updated in
place.

The other families of the JAX package (moe, xlstm, encdec) are not ported
yet: the port raises ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.utils.checkpoint

from .. import _device
from .._tree import tree_map
from . import layers as L
from . import recurrent as R
from .config import ATTN, RGLRU, ModelConfig

Tree = Dict[str, Union["Tree", torch.Tensor]]

_PENDING = {
    "moe": "ROADMAP A13b (moe family, models/moe.py)",
    "xlstm": "ROADMAP A13b (xlstm family, sLSTM/mLSTM cells)",
    "encdec": "ROADMAP A13b (encdec family)",
}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "griffin"):
        if cfg.family in _PENDING:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is not ported yet, "
                f"see {_PENDING[cfg.family]}")
        raise ValueError(cfg.family)


def _stack(trees: List[Tree]) -> Tree:
    return tree_map(lambda *ts: torch.stack(ts), *trees)


def _unstack(params: Tree, key: str, n: int) -> List[Tree]:
    """The ``n`` per-layer trees of the stacked ``params[key]`` (none when
    ``n`` is 0), by one ``unbind`` a leaf: its backward stacks the layers'
    gradients once, where indexing layer by layer would add a zero-padded
    full-size gradient per layer."""
    if not n:
        return []
    flat = tree_map(torch.unbind, params[key])
    return [tree_map(lambda ts: ts[i], flat) for i in range(n)]


def _n_groups(cfg: ModelConfig) -> Tuple[int, int]:
    n_groups = cfg.n_layers // 3
    return n_groups, cfg.n_layers - 3 * n_groups


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _dense_layer_init(cfg: ModelConfig, gen: torch.Generator) -> Tree:
    if cfg.n_experts > 0:
        raise NotImplementedError(
            f"{cfg.name}: routed experts are not ported yet, see "
            f"{_PENDING['moe']}")
    p: Tree = {"ln_attn": L.init_rmsnorm(cfg.d_model, cfg.param_dtype,
                                         gen.device)}
    p["attn"] = L.init_attention(cfg, gen)
    p["ln_mlp"] = L.init_rmsnorm(cfg.d_model, cfg.param_dtype, gen.device)
    p["mlp"] = L.init_mlp(cfg, gen)
    return p


def _griffin_sub_init(cfg: ModelConfig, kind: str,
                      gen: torch.Generator) -> Tree:
    p: Tree = {"ln": L.init_rmsnorm(cfg.d_model, cfg.param_dtype, gen.device)}
    p["block"] = (R.init_rg_lru(cfg, gen) if kind == RGLRU
                  else L.init_attention(cfg, gen))
    p["ln_mlp"] = L.init_rmsnorm(cfg.d_model, cfg.param_dtype, gen.device)
    p["mlp"] = L.init_mlp(cfg, gen)
    return p


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device: Union[str, torch.device] = "cuda") -> Tree:
    """Random parameters with the JAX init's shapes, scales and dtypes,
    drawn from ``generator`` on its own device and placed on ``device``.
    Raises when a CUDA device is asked for and there is none."""
    dev = _device.resolve(device)
    _check_family(cfg)
    gen = generator
    p: Tree = {
        "embed": L.truncated_normal(gen, (cfg.vocab, cfg.d_model),
                                    cfg.param_dtype, 0.02),
        "head": L.truncated_normal(gen, (cfg.d_model, cfg.vocab),
                                   cfg.param_dtype, 0.02),
        "ln_f": L.init_rmsnorm(cfg.d_model, cfg.param_dtype, gen.device),
    }
    if cfg.family == "dense":
        p["layers"] = _stack([_dense_layer_init(cfg, gen)
                              for _ in range(cfg.n_layers)])
    else:
        n_groups, n_tail = _n_groups(cfg)
        p["groups"] = _stack([{"rg1": _griffin_sub_init(cfg, RGLRU, gen),
                               "rg2": _griffin_sub_init(cfg, RGLRU, gen),
                               "attn": _griffin_sub_init(cfg, ATTN, gen)}
                              for _ in range(n_groups)])
        if n_tail:
            p["tail"] = _stack([_griffin_sub_init(cfg, RGLRU, gen)
                                for _ in range(n_tail)])
    return tree_map(lambda t: t.to(dev), p)


def param_count(params: Tree) -> int:
    n = 0
    for v in params.values():
        n += param_count(v) if isinstance(v, dict) else v.numel()
    return n


# ---------------------------------------------------------------------------
# Block body shared by forward and prefill
# ---------------------------------------------------------------------------

def _dense_block_seq(cfg: ModelConfig, x, lp, positions, cache=None,
                     cache_index=None):
    """Pre-norm attention and MLP residuals.  (The JAX package also returns
    the MoE aux loss here; for the dense family it is zero.)"""
    if cfg.bf16_grad_barrier:
        x = L.grad_bf16_barrier(x)
    h, new_cache = L.attention_layer(
        lp["attn"], cfg, L.rmsnorm(lp["ln_attn"], x, cfg.norm_eps),
        positions=positions, causal=True, cache=cache,
        cache_index=cache_index)
    x = x + h
    y = L.mlp(lp["mlp"], L.rmsnorm(lp["ln_mlp"], x, cfg.norm_eps))
    return x + y, new_cache


def _griffin_sub_seq(cfg: ModelConfig, x, sp, kind, positions, state=None,
                     cache=None, cache_index=None):
    h_in = L.rmsnorm(sp["ln"], x, cfg.norm_eps)
    new_state, new_cache = None, None
    if kind == RGLRU:
        h, new_state = R.griffin_recurrent_block(sp["block"], cfg, h_in, state)
    else:
        h, new_cache = L.attention_layer(
            sp["block"], cfg, h_in, positions=positions, causal=True,
            window=cfg.window, cache=cache, cache_index=cache_index)
    x = x + h
    x = x + L.mlp(sp["mlp"], L.rmsnorm(sp["ln_mlp"], x, cfg.norm_eps))
    return x, new_state, new_cache


def _logits(params: Tree, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return x.to(cfg.logit_dtype) @ params["head"].to(cfg.logit_dtype)


def _maybe_remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` recomputed in the backward pass under ``cfg.remat`` (when
    autograd records): ``torch.utils.checkpoint`` keeps only its inputs,
    which is the JAX package's ``nothing_saveable`` policy."""
    if not cfg.remat:
        return fn
    if cfg.remat_policy != "nothing":
        raise NotImplementedError(
            f"remat_policy {cfg.remat_policy!r}: the port recomputes "
            "everything ('nothing'); saving matmul outputs ('dots') comes "
            "with the families that use it (ROADMAP A13b)")

    def remat(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)

    return remat


# ---------------------------------------------------------------------------
# Training forward + loss
# ---------------------------------------------------------------------------

def forward(params: Tree, cfg: ModelConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward over whole sequences (no cache). tokens: (B, S) ->
    (logits (B, S, V) in ``cfg.logit_dtype``, moe_aux_loss); the dense and
    griffin families have no MoE, so the aux loss is a float32 zero.
    ``positions``: (B, S), or (3, B, S) for M-RoPE; None for 0..S-1."""
    _check_family(cfg)
    x = params["embed"][tokens].to(cfg.dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "dense":
        def layer(x, lp):
            return _dense_block_seq(cfg, x, lp, positions)[0]

        layer = _maybe_remat(layer, cfg)
        for lp in _unstack(params, "layers", cfg.n_layers):
            x = layer(x, lp)
        return _logits(params, cfg, x), aux
    n_groups, n_tail = _n_groups(cfg)

    def body(x, gp):
        x, _, _ = _griffin_sub_seq(cfg, x, gp["rg1"], RGLRU, positions)
        x, _, _ = _griffin_sub_seq(cfg, x, gp["rg2"], RGLRU, positions)
        x, _, _ = _griffin_sub_seq(cfg, x, gp["attn"], ATTN, positions)
        return x

    def tbody(x, tp):
        x, _, _ = _griffin_sub_seq(cfg, x, tp, RGLRU, positions)
        return x

    body, tbody = _maybe_remat(body, cfg), _maybe_remat(tbody, cfg)
    for gp in _unstack(params, "groups", n_groups):
        x = body(x, gp)
    for tp in _unstack(params, "tail", n_tail):
        x = tbody(x, tp)
    return _logits(params, cfg, x), aux


class _TokenCrossEntropy(torch.autograd.Function):
    """logsumexp(logits) - logits[label] per token, (B, S, V) -> (B, S).

    The backward writes softmax(logits) - onehot(label) into one new
    (B, S, V) buffer: at full width one micro-batch's float32 logits are
    4.2 GB, and autograd through ``logsumexp`` and ``gather`` would hold
    two or three more of that size."""

    @staticmethod
    def forward(ctx, logits, labels):
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[..., None])[..., 0]
        ctx.save_for_backward(logits, logz, labels)
        return logz - gold

    @staticmethod
    def backward(ctx, g):
        logits, logz, labels = ctx.saved_tensors
        p = torch.sub(logits, logz[..., None]).exp_()
        p.scatter_add_(-1, labels[..., None],
                       torch.full_like(labels[..., None], -1.0,
                                       dtype=p.dtype))
        return p.mul_(g[..., None]), None


def loss_fn(params: Tree, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy (+ MoE load-balance aux); labels < 0 are
    masked.  Returns (total, {"ce", "aux", "tokens"})."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          positions=batch.get("positions"))
    labels = batch["labels"]
    valid = labels >= 0
    ce = _TokenCrossEntropy.apply(logits, labels.clamp_min(0).long()) * valid
    n_valid = valid.sum()
    loss = ce.sum() / n_valid.clamp_min(1)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux,
                                     "tokens": n_valid}


# ---------------------------------------------------------------------------
# Serving: cache init, prefill, decode step
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               prefill: bool = False,
               device: Union[str, torch.device] = "cuda") -> Tree:
    """Decode state. Attention caches are in ``cfg.dtype``.

    Dense: a (n_layers, B, max_len, n_kv, head_dim) key and value cache.
    Griffin: the decode cache is a ring buffer of the window size; prefill
    uses a full-length buffer instead (and decode after prefill keeps it,
    so it attends over every earlier position: ROADMAP C3)."""
    _check_family(cfg)
    dev = _device.resolve(device)
    hd, kv = cfg.head_dim, cfg.n_kv

    def zeros(*shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=dev)

    if cfg.family == "dense":
        return {"k": zeros(cfg.n_layers, batch, max_len, kv, hd),
                "v": zeros(cfg.n_layers, batch, max_len, kv, hd),
                "index": torch.zeros((), dtype=torch.int32, device=dev)}
    n_groups, n_tail = _n_groups(cfg)
    win = max_len if prefill else min(cfg.window or max_len, max_len)
    w = cfg.lru_width or cfg.d_model
    cache: Tree = {
        "k": zeros(n_groups, batch, win, kv, hd),
        "v": zeros(n_groups, batch, win, kv, hd),
        "conv": zeros(n_groups, 2, batch, cfg.conv_width - 1, w),
        "h": zeros(n_groups, 2, batch, w),
        "index": torch.zeros((), dtype=torch.int32, device=dev),
    }
    if n_tail:
        cache["tail_conv"] = zeros(n_tail, batch, cfg.conv_width - 1, w)
        cache["tail_h"] = zeros(n_tail, batch, w)
    return cache


@torch.no_grad()
def prefill(params: Tree, cfg: ModelConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Tree]:
    """Process the prompt, build the decode state. Returns (last_logits
    (B, 1, V), cache); ``max_len`` reserves cache room for decoding.  Runs
    on the device of the parameters, without autograd."""
    _check_family(cfg)
    b, s = tokens.shape
    cache = init_cache(cfg, b, max(max_len or s, s), prefill=True,
                       device=params["embed"].device)
    x = params["embed"][tokens].to(cfg.dtype)
    if cfg.family == "dense":
        for i, lp in enumerate(_unstack(params, "layers", cfg.n_layers)):
            x, _ = _dense_block_seq(cfg, x, lp, positions,
                                    cache=(cache["k"][i], cache["v"][i]),
                                    cache_index=0)
        cache["index"].fill_(s)
        return _logits(params, cfg, x[:, -1:]), cache
    n_groups, n_tail = _n_groups(cfg)
    for i, gp in enumerate(_unstack(params, "groups", n_groups)):
        x, s1, _ = _griffin_sub_seq(cfg, x, gp["rg1"], RGLRU, positions)
        x, s2, _ = _griffin_sub_seq(cfg, x, gp["rg2"], RGLRU, positions)
        x, _, _ = _griffin_sub_seq(cfg, x, gp["attn"], ATTN, positions,
                                   cache=(cache["k"][i], cache["v"][i]),
                                   cache_index=0)
        for j, st in enumerate((s1, s2)):
            cache["conv"][i, j] = st["conv"]
            cache["h"][i, j] = st["h"]
    for i, tp in enumerate(_unstack(params, "tail", n_tail)):
        x, st, _ = _griffin_sub_seq(cfg, x, tp, RGLRU, positions)
        cache["tail_conv"][i] = st["conv"]
        cache["tail_h"][i] = st["h"]
    cache["index"].fill_(s)
    return _logits(params, cfg, x[:, -1:]), cache


def _ring_positions(win: int, index: torch.Tensor) -> torch.Tensor:
    """Absolute position stored in each ring-buffer slot at time ``index``."""
    i = torch.arange(win, device=index.device)
    return index - ((index - i) % win)


@torch.no_grad()
def decode_step(params: Tree, cfg: ModelConfig, cache: Tree,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Tree]:
    """One token step. tokens: (B, 1). Returns (logits (B,1,V), cache).

    The cache's tensors are updated in place and returned with the index
    advanced; the step reads no value back to the host."""
    _check_family(cfg)
    b = tokens.shape[0]
    index = cache["index"]
    x = params["embed"][tokens].to(cfg.dtype)
    pos = index.reshape(1, 1).expand(b, 1)
    if cfg.family == "dense":
        for i, lp in enumerate(_unstack(params, "layers", cfg.n_layers)):
            x, _ = _dense_block_seq(cfg, x, lp, pos,
                                    cache=(cache["k"][i], cache["v"][i]),
                                    cache_index=index)
        return _logits(params, cfg, x), dict(cache, index=index + 1)
    win = cache["k"].shape[2]
    slot = (index % win).reshape(1).long()
    kpos = _ring_positions(win, index)
    valid = (kpos <= index) & (index - kpos < win) & (kpos >= 0)
    hd, n_h, n_kv = cfg.head_dim, cfg.n_heads, cfg.n_kv

    def attn_ring(sp, x_in, ck, cv):
        h_in = L.rmsnorm(sp["ln"], x_in, cfg.norm_eps)
        ap = sp["block"]
        q = (h_in @ ap["wq"]).reshape(b, 1, n_h, hd)
        k = (h_in @ ap["wk"]).reshape(b, 1, n_kv, hd)
        v = (h_in @ ap["wv"]).reshape(b, 1, n_kv, hd)
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
        ck.index_copy_(1, slot, k.to(ck.dtype))
        cv.index_copy_(1, slot, v.to(cv.dtype))
        sc = torch.einsum(
            "bqkgd,bckd->bkgqc",
            q.reshape(b, 1, n_kv, n_h // n_kv, hd).float(),
            ck.float()) / math.sqrt(hd)
        sc = torch.where(valid, sc, L.NEG_INF)
        w = torch.softmax(sc, dim=-1)
        o = torch.einsum("bkgqc,bckd->bkgqd", w, cv.float())
        o = o.permute(0, 3, 1, 2, 4).reshape(b, 1, n_h * hd).to(x_in.dtype)
        x_new = x_in + o @ ap["wo"]
        return x_new + L.mlp(sp["mlp"],
                             L.rmsnorm(sp["ln_mlp"], x_new, cfg.norm_eps))

    n_groups, n_tail = _n_groups(cfg)
    for i, gp in enumerate(_unstack(params, "groups", n_groups)):
        for j, name in enumerate(("rg1", "rg2")):
            st = {"conv": cache["conv"][i, j], "h": cache["h"][i, j]}
            x, st, _ = _griffin_sub_seq(cfg, x, gp[name], RGLRU, pos, state=st)
            cache["conv"][i, j] = st["conv"]
            cache["h"][i, j] = st["h"]
        x = attn_ring(gp["attn"], x, cache["k"][i], cache["v"][i])
    for i, tp in enumerate(_unstack(params, "tail", n_tail)):
        st = {"conv": cache["tail_conv"][i], "h": cache["tail_h"][i]}
        x, st, _ = _griffin_sub_seq(cfg, x, tp, RGLRU, pos, state=st)
        cache["tail_conv"][i] = st["conv"]
        cache["tail_h"][i] = st["h"]
    new_cache = dict(cache, index=index + 1)
    return _logits(params, cfg, x), new_cache
