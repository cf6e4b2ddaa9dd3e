"""Model assembly: init / forward + loss / prefill / decode for all families.

Families:
  dense   -- pre-norm GQA transformer (llama3/qwen3/internlm2/starcoder2,
             qwen2-vl backbone with M-RoPE)
  moe     -- dense skeleton with routed-expert FFN (+ shared experts /
             arctic's parallel dense residual)
  griffin -- RecurrentGemma: repeating (RG-LRU, RG-LRU, local attention)
             groups, every temporal block followed by an MLP, and a tail of
             RG-LRU sublayers when the layer count is not a multiple of 3
  xlstm   -- alternating sLSTM / mLSTM blocks (no separate FFN)
  encdec  -- whisper backbone: bidirectional encoder over stub frame
             embeddings + causal decoder with cross-attention

The JAX package's ``models/model.py`` op for op; parameters keep its tree,
with the per-layer weights of ``layers`` (dense, moe), ``groups`` and
``tail`` (griffin), ``pairs`` (xlstm), ``enc`` and ``dec`` (encdec) stacked
on a leading axis, and its ``lax.scan`` over layers is a Python loop.  With
``cfg.remat`` the training forward recomputes each layer, group or pair in
the backward pass (``torch.utils.checkpoint``), by ``cfg.remat_policy`` as
the JAX package does: ``"nothing"`` saves nothing inside
(``nothing_saveable``), ``"dots"`` saves the outputs of the products
without batch dimensions (``dots_with_no_batch_dims_saveable``; see
:mod:`.remat`).  Serving runs without autograd; caches are updated in
place.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
from torch.distributed.tensor import Partial, Replicate, Shard

from .. import _device
from .._tree import leaves, tree_map
from ..kernels import ops as kernel_ops
from ..sharding import (best_spec, distribute, gather_fsdp, logical_shard,
                        shard_tree)
from ..sharding.local import (is_dtensor, local_range, on_local, replicated,
                              settled, split_dims)
from . import layers as L
from . import moe as MOE
from . import recurrent as R
from . import remat
from .config import ATTN, RGLRU, ModelConfig

Tree = Dict[str, Union["Tree", torch.Tensor]]
# the counters a layer may report, each with how a forward joins it over
# the layers and a train step over its micro-batches
COUNTERS: Dict[str, Callable] = dict(MOE.COUNTERS)


def _stack(trees: List[Tree]) -> Tree:
    return tree_map(lambda *ts: torch.stack(ts), *trees)


def _gather(params: Tree, cfg: ModelConfig, key: str) -> Callable:
    """For a stack of layers ``params[key]``: a function that makes one
    layer's DTensor parameters whole over their FSDP axes
    (``sharding.gather_fsdp``), called inside the layer's body so that its
    gathered weights live while it runs (and are gathered again by remat's
    recompute); the identity on plain tensors."""
    stack = params.get(key)
    if stack is None or not is_dtensor(leaves(stack)[0]):
        return lambda tree: tree
    specs = tree_map(lambda s: tuple(s)[1:], logical_specs(cfg)[key])
    return lambda tree: gather_fsdp(tree, specs)


def _layers(params: Tree, cfg: ModelConfig, key: str, n: int):
    """The ``n`` layers of ``params[key]`` one at a time, each made whole
    over its FSDP axes as it is reached (serving: no remat)."""
    whole = _gather(params, cfg, key)
    for lp in _unstack(params, key, n):
        yield whole(lp)


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
    p: Tree = {"ln_attn": L.init_rmsnorm(cfg.d_model, cfg.param_dtype,
                                         gen.device)}
    p["attn"] = L.init_attention(cfg, gen)
    p["ln_mlp"] = L.init_rmsnorm(cfg.d_model, cfg.param_dtype, gen.device)
    if cfg.n_experts > 0:
        p["moe"] = MOE.init_moe(cfg, gen)
        if cfg.dense_residual:
            p["mlp"] = L.init_mlp(cfg, gen)
        if cfg.n_shared > 0:
            p["shared"] = L.init_mlp(
                cfg, gen, d_ff=cfg.n_shared * (cfg.moe_d_ff or cfg.d_ff))
    else:
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


def _xlstm_pair_init(cfg: ModelConfig, gen: torch.Generator) -> Tree:
    return {"ln_s": L.init_rmsnorm(cfg.d_model, cfg.param_dtype, gen.device),
            "slstm": R.init_slstm(cfg, gen),
            "ln_m": L.init_rmsnorm(cfg.d_model, cfg.param_dtype, gen.device),
            "mlstm": R.init_mlstm(cfg, gen)}


def _enc_layer_init(cfg: ModelConfig, gen: torch.Generator) -> Tree:
    return {"ln_attn": L.init_layernorm(cfg.d_model, cfg.param_dtype,
                                        gen.device),
            "attn": L.init_attention(cfg, gen),
            "ln_mlp": L.init_layernorm(cfg.d_model, cfg.param_dtype,
                                       gen.device),
            "mlp": L.init_mlp(cfg, gen)}


def _dec_layer_init(cfg: ModelConfig, gen: torch.Generator) -> Tree:
    return {"ln_self": L.init_layernorm(cfg.d_model, cfg.param_dtype,
                                        gen.device),
            "self_attn": L.init_attention(cfg, gen),
            "ln_cross": L.init_layernorm(cfg.d_model, cfg.param_dtype,
                                         gen.device),
            "cross_attn": L.init_attention(cfg, gen, cross=True),
            "ln_mlp": L.init_layernorm(cfg.d_model, cfg.param_dtype,
                                       gen.device),
            "mlp": L.init_mlp(cfg, gen)}


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device: Union[str, torch.device] = "cuda") -> Tree:
    """Random parameters with the JAX init's shapes, scales and dtypes,
    drawn from ``generator`` on its own device and placed on ``device``.
    Raises when a CUDA device is asked for and there is none."""
    dev = _device.resolve(device)
    gen = generator
    p: Tree = {
        "embed": L.truncated_normal(gen, (cfg.vocab, cfg.d_model),
                                    cfg.param_dtype, 0.02),
        "head": L.truncated_normal(gen, (cfg.d_model, cfg.vocab),
                                   cfg.param_dtype, 0.02),
        "ln_f": L.init_rmsnorm(cfg.d_model, cfg.param_dtype, gen.device),
    }
    if cfg.family in ("dense", "moe"):
        p["layers"] = _stack([_dense_layer_init(cfg, gen)
                              for _ in range(cfg.n_layers)])
    elif cfg.family == "griffin":
        n_groups, n_tail = _n_groups(cfg)
        p["groups"] = _stack([{"rg1": _griffin_sub_init(cfg, RGLRU, gen),
                               "rg2": _griffin_sub_init(cfg, RGLRU, gen),
                               "attn": _griffin_sub_init(cfg, ATTN, gen)}
                              for _ in range(n_groups)])
        if n_tail:
            p["tail"] = _stack([_griffin_sub_init(cfg, RGLRU, gen)
                                for _ in range(n_tail)])
    elif cfg.family == "xlstm":
        if cfg.n_layers % 2:
            raise ValueError(f"xlstm: {cfg.n_layers} layers is not a whole "
                             "number of sLSTM/mLSTM pairs")
        p["pairs"] = _stack([_xlstm_pair_init(cfg, gen)
                             for _ in range(cfg.n_layers // 2)])
    elif cfg.family == "encdec":
        p["enc"] = _stack([_enc_layer_init(cfg, gen)
                           for _ in range(cfg.n_enc_layers)])
        p["dec"] = _stack([_dec_layer_init(cfg, gen)
                           for _ in range(cfg.n_layers)])
        p["ln_enc"] = L.init_layernorm(cfg.d_model, cfg.param_dtype,
                                       gen.device)
    else:
        raise ValueError(cfg.family)
    return tree_map(lambda t: t.to(dev), p)


class _ShapeOnly:
    """Stands in for a ``torch.Generator`` on the meta device: the init
    then makes tensors with shapes and dtypes and draws nothing."""
    device = torch.device("meta")


def abstract_params(cfg: ModelConfig) -> Tree:
    """:func:`init_model`'s parameters as meta tensors: their shapes and
    dtypes, nothing drawn or allocated (the counterpart of the JAX
    package's ``jax.eval_shape`` of the init)."""
    return init_model(cfg, _ShapeOnly(), device="meta")


def _stack_specs(spec: Tree) -> Tree:
    """A per-layer spec tree with the stacked leading (layer) axis."""
    return tree_map(lambda s: (None,) + tuple(s), spec)


def logical_specs(cfg: ModelConfig) -> Tree:
    """The logical axes of :func:`init_model`'s parameters, leaf for leaf
    (the JAX package's ``init_model`` returns them as its second value):
    a tuple with one logical axis name, or None, per tensor dim."""
    norm = L.norm_specs
    s: Tree = {"embed": ("w_vocab", "w_embed"),
               "head": ("w_embed", "w_vocab"), "ln_f": norm()}
    if cfg.family in ("dense", "moe"):
        lp: Tree = {"ln_attn": norm(), "attn": L.attention_specs(cfg),
                    "ln_mlp": norm()}
        if cfg.n_experts > 0:
            lp["moe"] = MOE.moe_specs()
            if cfg.dense_residual:
                lp["mlp"] = L.mlp_specs()
            if cfg.n_shared > 0:
                lp["shared"] = L.mlp_specs()
        else:
            lp["mlp"] = L.mlp_specs()
        s["layers"] = _stack_specs(lp)
    elif cfg.family == "griffin":
        def sub(block):
            return {"ln": norm(), "block": block, "ln_mlp": norm(),
                    "mlp": L.mlp_specs()}
        n_groups, n_tail = _n_groups(cfg)
        rg = R.rg_lru_specs()
        s["groups"] = _stack_specs({"rg1": sub(rg), "rg2": sub(rg),
                                    "attn": sub(L.attention_specs(cfg))})
        if n_tail:
            s["tail"] = _stack_specs(sub(rg))
    elif cfg.family == "xlstm":
        s["pairs"] = _stack_specs({"ln_s": norm(), "slstm": R.slstm_specs(),
                                   "ln_m": norm(), "mlstm": R.mlstm_specs()})
    elif cfg.family == "encdec":
        ln = norm(bias=True)
        s["enc"] = _stack_specs({"ln_attn": ln, "attn": L.attention_specs(cfg),
                                 "ln_mlp": ln, "mlp": L.mlp_specs()})
        s["dec"] = _stack_specs({
            "ln_self": ln, "self_attn": L.attention_specs(cfg),
            "ln_cross": ln, "cross_attn": L.attention_specs(cfg),
            "ln_mlp": ln, "mlp": L.mlp_specs()})
        s["ln_enc"] = ln
    else:
        raise ValueError(cfg.family)
    return s


def param_count(params: Tree) -> int:
    n = 0
    for v in params.values():
        n += param_count(v) if isinstance(v, dict) else v.numel()
    return n


# ---------------------------------------------------------------------------
# Block body shared by forward and prefill
# ---------------------------------------------------------------------------

def _dense_block_seq(cfg: ModelConfig, x, lp, positions, cache=None,
                     cache_index=None, layer: int = 0):
    """Pre-norm attention and MLP (or MoE) residuals of layer ``layer``,
    with its window and rope (``cfg.layer_window``, ``cfg.layer_yarn``):
    (x, moe aux loss, cache, counters); the aux loss is a float32 zero
    without experts, the counters those of the held experts' layer
    (``moe.held_experts_block``), else empty."""
    if cfg.bf16_grad_barrier:
        x = L.grad_bf16_barrier(x)
    h, new_cache = L.attention_layer(
        lp["attn"], cfg, L.rmsnorm(lp["ln_attn"], x, cfg.norm_eps),
        positions=positions, causal=True, window=cfg.layer_window(layer),
        yarn=cfg.layer_yarn(layer), cache=cache, cache_index=cache_index)
    x = x + h
    y_in = L.rmsnorm(lp["ln_mlp"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    counters: Dict[str, torch.Tensor] = {}
    if cfg.n_experts > 0:
        if cfg.held_experts:
            y, aux, counters = MOE.held_experts_block(lp["moe"], cfg, y_in)
        else:
            y, aux = MOE.moe_block(lp["moe"], cfg, y_in)
        if cfg.dense_residual:
            y = y + L.mlp(lp["mlp"], y_in)
        if cfg.n_shared > 0:
            y = y + L.mlp(lp["shared"], y_in)
    else:
        y = L.mlp(lp["mlp"], y_in)
    return x + y, aux, new_cache, counters


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


def _xlstm_pair_seq(cfg: ModelConfig, x, pp, return_state: bool = False):
    """An sLSTM and an mLSTM residual over whole sequences; with
    ``return_state`` also the two cells' final states."""
    y, s_state = R.slstm_scan(pp["slstm"],
                              L.rmsnorm(pp["ln_s"], x, cfg.norm_eps))
    x = x + y
    out = R.mlstm_chunkwise(pp["mlstm"], cfg,
                            L.rmsnorm(pp["ln_m"], x, cfg.norm_eps),
                            return_state=return_state)
    if not return_state:
        return x + out
    y, m_state = out
    return x + y, s_state, m_state


def _dec_layer_seq(cfg: ModelConfig, x, lp, enc_out, positions=None,
                   cache=None, cache_index=None):
    """Decoder layer: causal self-attention, cross-attention over the
    encoder's output, MLP; layernorm before each."""
    h, new_cache = L.attention_layer(
        lp["self_attn"], cfg, L.layernorm(lp["ln_self"], x, cfg.norm_eps),
        positions=positions, causal=True, cache=cache,
        cache_index=cache_index)
    x = x + h
    h, _ = L.attention_layer(
        lp["cross_attn"], cfg, L.layernorm(lp["ln_cross"], x, cfg.norm_eps),
        kv_source=enc_out)
    x = x + h
    x = x + L.mlp(lp["mlp"], L.layernorm(lp["ln_mlp"], x, cfg.norm_eps))
    return x, new_cache


def _encoder(params: Tree, cfg: ModelConfig,
             frames: torch.Tensor) -> torch.Tensor:
    """Whisper encoder over stub frame embeddings (bidirectional).  The JAX
    package passes positions 0..F-1 explicitly; the port passes None, the
    same positions, so that on the card the frames take the flash kernel."""
    x = logical_shard(frames.to(cfg.dtype), "batch", None, None)
    whole = _gather(params, cfg, "enc")

    def body(x, lp):
        lp = whole(lp)
        h, _ = L.attention_layer(
            lp["attn"], cfg, L.layernorm(lp["ln_attn"], x, cfg.norm_eps),
            causal=False)
        x = x + h
        return x + L.mlp(lp["mlp"],
                         L.layernorm(lp["ln_mlp"], x, cfg.norm_eps))

    body = _maybe_remat(body, cfg)
    for lp in _unstack(params, "enc", cfg.n_enc_layers):
        x = body(x, lp)
    return L.layernorm(params["ln_enc"], x, cfg.norm_eps)


def _need_frames(cfg: ModelConfig, frames: Optional[torch.Tensor]) -> None:
    if frames is None:
        raise ValueError(
            f"{cfg.name}: encdec needs stub frame embeddings: pass frames, "
            f"(B, S // {cfg.enc_frames_ratio}, {cfg.d_model})")


def _embed(params: Tree, cfg: ModelConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    """The token rows of the table, through :func:`on_local`: on a DTensor
    table vocab-parallel (the table is gathered over the mesh dims that
    split the tokens, each rank looks up the tokens that fall in its vocab
    rows, zeros elsewhere, and the result is a partial sum over the mesh
    dims that split the vocab: one rank holds each row, so the sum is
    exact).  DTensor's own rule for ``embedding`` (a masked partial) fails
    in the backward of a sliced micro-batch."""
    table = logical_shard(params["embed"], "w_vocab", None)
    lookup, lo = None, 0
    if is_dtensor(table):
        mesh = table.device_mesh
        if not is_dtensor(tokens):  # the global batch, alike on every rank
            tokens = distribute(tokens, best_spec(tokens.shape,
                                                  ("batch", None)), mesh)
        tokens = logical_shard(tokens, "batch", None)
        tok = list(tokens.placements)
        want = [Replicate() if (t.is_shard() and mesh.shape[i] > 1) else pl
                for i, (t, pl) in enumerate(zip(tok, table.placements))]
        if any(pl.is_shard() and pl.dim != 0 for pl in want):
            raise ValueError(f"embedding: the model dim of the table is "
                             f"split ({table.placements})")
        lo = local_range(table, 0, want)[0]
        lookup = dict(
            layouts=(None, want),
            grads=(None, [Partial() if t.is_shard() else pl
                          for t, pl in zip(tok, want)]),
            out=[Partial() if pl.is_shard() else t
                 for t, pl in zip(tok, want)])

    def rows(ids, block):
        if block.shape[0] == table.shape[0]:  # the whole vocab
            return torch.nn.functional.embedding(ids, block)
        hit = (ids >= lo) & (ids < lo + block.shape[0])
        out = torch.nn.functional.embedding(torch.where(hit, ids - lo, 0),
                                            block)
        return out * hit[..., None].to(out.dtype)

    x = on_local(rows, (tokens, table), ((), (1,)), "embedding",
                 **(lookup or {}))
    return logical_shard(x.to(cfg.dtype), "batch", None, None)


def _head_product(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """float32 logits (..., V) of the bfloat16 norm output x (..., d) and
    head (d, V) by the head's kernels (``kernels.ops.lm_head``: the float32
    products on the tensor cores).  On DTensors through :func:`on_local`:
    each rank multiplies its rows of x by its vocab columns of the head,
    both whole over d (x's row splits kept, the head's vocab split kept
    where x's rows are whole on that mesh dim, all else gathered); x's
    gradient block is a partial sum over the mesh dims that split the
    vocab, the head's over those that split x's rows."""
    if not (is_dtensor(x) or is_dtensor(head)):
        return kernel_ops.lm_head(x, head)
    mesh = (x if is_dtensor(x) else head).device_mesh
    nd = x.dim()
    rows, cols, out, grad_x, grad_head = [], [], [], [], []
    for i, n in enumerate(mesh.shape):
        px = x.placements[i] if is_dtensor(x) else Replicate()
        ph = head.placements[i] if is_dtensor(head) else Replicate()
        px = px if px.is_shard() and px.dim % nd != nd - 1 else Replicate()
        ph = ph if (ph.is_shard() and ph.dim % 2 == 1
                    and not px.is_shard()) else Replicate()
        rows.append(px)
        cols.append(ph)
        out.append(px if px.is_shard()
                   else Shard(nd - 1) if ph.is_shard() else Replicate())
        grad_x.append(Partial() if n > 1 and ph.is_shard() else px)
        grad_head.append(Partial() if n > 1 and px.is_shard() else ph)
    return on_local(kernel_ops.lm_head, (x, head), ((-1,), (0,)), "lm_head",
                    layouts=(rows, cols), grads=(grad_x, grad_head),
                    out=out)


def _logits(params: Tree, cfg: ModelConfig, x: torch.Tensor,
            shard: bool = True) -> torch.Tensor:
    """The head over the final norm; ``shard`` constrains the logits to
    (batch, -, vocab_act) as the JAX package's forward and decode do (its
    prefill does not).  float32 logits of a bfloat16 norm output and head
    on the card go through the head's kernels (:func:`_head_product`: the
    same float32 products on the tensor cores, on DTensors each rank's
    block); float32 parameters and CPU tensors through the float32
    product."""
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    head = gather_fsdp(params["head"], ("w_embed", "w_vocab"))
    if (cfg.logit_dtype == torch.float32 and x.device.type == "cuda"
            and x.dtype == head.dtype == torch.bfloat16):
        logits = _head_product(x, head)
    else:
        logits = x.to(cfg.logit_dtype) @ head.to(cfg.logit_dtype)
    return logical_shard(logits, "batch", None, "vocab_act") if shard \
        else logits


def _maybe_remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` recomputed in the backward pass under ``cfg.remat`` (when
    autograd records), by ``cfg.remat_policy``: ``"nothing"`` keeps only
    its inputs, ``"dots"`` also the outputs of its products without batch
    dimensions (:mod:`.remat`); any other policy raises ``ValueError``."""
    return remat.wrap(fn, cfg.remat_policy) if cfg.remat else fn


# ---------------------------------------------------------------------------
# Training forward + loss
# ---------------------------------------------------------------------------

def forward(params: Tree, cfg: ModelConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward over whole sequences (no cache). tokens: (B, S) ->
    (logits (B, S, V) in ``cfg.logit_dtype``, moe_aux_loss), the aux loss
    a float32 scalar summed over the layers (zero without experts).
    ``positions``: (B, S), or (3, B, S) for M-RoPE; None for 0..S-1.
    ``frames``: the encdec family's stub frame embeddings (B, F, d_model)."""
    logits, aux, _ = _forward(params, cfg, tokens, positions, frames)
    return logits, aux


def join_counters(acc: Dict[str, torch.Tensor],
                  new: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``acc`` with ``new``'s counters joined in, each by its rule in
    :data:`COUNTERS`."""
    return {**acc, **{k: COUNTERS[k](acc[k], v) if k in acc else v
                      for k, v in new.items()}}


def _forward(params: Tree, cfg: ModelConfig, tokens: torch.Tensor,
             positions: Optional[torch.Tensor],
             frames: Optional[torch.Tensor]):
    """:func:`forward`'s (logits, aux loss) and the counters its layers
    report, joined over the layers (:func:`join_counters`)."""
    x = _embed(params, cfg, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    counters: Dict[str, torch.Tensor] = {}
    if cfg.family in ("dense", "moe"):
        whole = _gather(params, cfg, "layers")

        def layer(x, aux, lp, i):
            x, a, _, c = _dense_block_seq(cfg, x, whole(lp), positions,
                                          layer=i)
            return x, aux + a, c  # the counters leave a checkpoint as outputs

        layer = _maybe_remat(layer, cfg)
        for i, lp in enumerate(_unstack(params, "layers", cfg.n_layers)):
            x, aux, c = layer(x, aux, lp, i)
            counters = join_counters(counters, c)
    elif cfg.family == "griffin":
        n_groups, n_tail = _n_groups(cfg)
        whole_g, whole_t = (_gather(params, cfg, "groups"),
                            _gather(params, cfg, "tail"))

        def body(x, gp):
            gp = whole_g(gp)
            x, _, _ = _griffin_sub_seq(cfg, x, gp["rg1"], RGLRU, positions)
            x, _, _ = _griffin_sub_seq(cfg, x, gp["rg2"], RGLRU, positions)
            x, _, _ = _griffin_sub_seq(cfg, x, gp["attn"], ATTN, positions)
            return x

        def tbody(x, tp):
            x, _, _ = _griffin_sub_seq(cfg, x, whole_t(tp), RGLRU,
                                       positions)
            return x

        body, tbody = _maybe_remat(body, cfg), _maybe_remat(tbody, cfg)
        for gp in _unstack(params, "groups", n_groups):
            x = body(x, gp)
        for tp in _unstack(params, "tail", n_tail):
            x = tbody(x, tp)
    elif cfg.family == "xlstm":
        whole = _gather(params, cfg, "pairs")
        body = _maybe_remat(
            lambda x, pp: _xlstm_pair_seq(cfg, x, whole(pp)), cfg)
        for pp in _unstack(params, "pairs", cfg.n_layers // 2):
            x = body(x, pp)
    elif cfg.family == "encdec":
        _need_frames(cfg, frames)
        enc_out = _encoder(params, cfg, frames)
        whole = _gather(params, cfg, "dec")
        body = _maybe_remat(
            lambda x, lp, enc: _dec_layer_seq(cfg, x, whole(lp), enc)[0],
            cfg)
        for lp in _unstack(params, "dec", cfg.n_layers):
            x = body(x, lp, enc_out)
    else:
        raise ValueError(cfg.family)
    return _logits(params, cfg, x), aux, counters


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


class _VocabParallelCrossEntropy(torch.autograd.Function):
    """:class:`_TokenCrossEntropy` on each rank's block of logits split
    over the vocab: the row max, the sum of exponentials and the gold
    logit (held by one rank) are all-reduced over the mesh dims that split
    the vocab, (B, S) floats each, as a reduction over a sharded vocab
    lowers in the JAX package; the backward needs no communication.
    ``lo`` is the first vocab id of the rank's block."""

    @staticmethod
    def forward(ctx, logits, labels, lo, groups):
        from torch.distributed import _functional_collectives as funcol

        def reduce(t, op):
            for g in groups:
                t = funcol.wait_tensor(funcol.all_reduce(t, op, g))
            return t

        m = reduce(logits.amax(dim=-1), "max")
        sumexp = reduce(torch.sub(logits, m[..., None]).exp_().sum(dim=-1),
                        "sum")
        logz = m + sumexp.log()
        local = labels - lo
        hit = (local >= 0) & (local < logits.shape[-1])
        local = torch.where(hit, local, 0)
        gold = reduce(logits.gather(-1, local[..., None])[..., 0] * hit,
                      "sum")
        ctx.save_for_backward(logits, logz, local, hit)
        return logz - gold

    @staticmethod
    def backward(ctx, g):
        logits, logz, local, hit = ctx.saved_tensors
        p = torch.sub(logits, logz[..., None]).exp_()
        p.scatter_add_(-1, local[..., None], -hit[..., None].to(p.dtype))
        return p.mul_(g[..., None]), None, None, None


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """Per-token cross entropy (B, S), through :func:`on_local`: on
    DTensors each rank computes its batch rows; where the logits' vocab is
    split over the mesh (the ``vocab_act`` layout), vocab-parallel."""
    if not is_dtensor(logits) or 2 not in split_dims(logits):
        return on_local(_TokenCrossEntropy.apply, (logits, labels),
                        ((2,), ()), "cross_entropy")
    logits = settled(logits)
    mesh = logits.device_mesh
    groups = [mesh.get_group(i) for i, p in enumerate(logits.placements)
              if p.is_shard() and p.dim == 2 and mesh.shape[i] > 1]
    # the labels and the result split as the logits' rows are
    rows = [p if p.is_shard() and p.dim == 0 else Replicate()
            for p in logits.placements]
    lo, _ = local_range(logits, 2)
    return on_local(
        lambda lg, lb: _VocabParallelCrossEntropy.apply(lg, lb, lo, groups),
        (logits, labels), ((), ()), "cross_entropy",
        layouts=(None, rows), out=rows)


def loss_fn(params: Tree, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy (+ MoE load-balance aux); labels < 0 are
    masked.  Returns (total, {"ce", "aux", "tokens"}, and the counters
    that the layers report: :data:`COUNTERS`)."""
    logits, aux, counters = _forward(params, cfg, batch["tokens"],
                                     batch.get("positions"),
                                     batch.get("frames"))
    labels = logical_shard(batch["labels"], "batch", None)
    valid = labels >= 0
    ce = _cross_entropy(logits, labels.clamp_min(0).long()) * valid
    # sums over DTensor rows are reduced here: a pending (partial) sum
    # would read back as one rank's share
    n_valid = replicated(valid.sum())
    loss = replicated(ce.sum()) / n_valid.clamp_min(1)
    aux = replicated(aux)
    return loss + aux_weight * aux, {
        "ce": loss, "aux": aux, "tokens": n_valid,
        **{k: replicated(v) for k, v in counters.items()}}


# ---------------------------------------------------------------------------
# Serving: cache init, prefill, decode step
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               prefill: bool = False,
               device: Union[str, torch.device] = "cuda") -> Tree:
    """Decode state. Attention caches are in ``cfg.dtype``.

    Dense, moe: a (n_layers, B, max_len, n_kv, head_dim) key and value
    cache.  Griffin: the decode cache is a ring buffer of the window size;
    prefill uses a full-length buffer instead (and decode after prefill
    keeps it, so it attends over every earlier position: ROADMAP C3).
    Xlstm: the cells' float32 states.  Encdec: the decoder's key and value
    cache and the encoder's output over ``max_len // enc_frames_ratio``
    frames (prefill replaces it with the prompt's)."""
    dev = _device.resolve(device)
    hd, kv = cfg.head_dim, cfg.n_kv

    def zeros(*shape, dtype=cfg.dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def full(value, *shape):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    index = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.family in ("dense", "moe"):
        return {"k": zeros(cfg.n_layers, batch, max_len, kv, hd),
                "v": zeros(cfg.n_layers, batch, max_len, kv, hd),
                "index": index}
    if cfg.family == "griffin":
        n_groups, n_tail = _n_groups(cfg)
        win = max_len if prefill else min(cfg.window or max_len, max_len)
        w = cfg.lru_width or cfg.d_model
        cache: Tree = {
            "k": zeros(n_groups, batch, win, kv, hd),
            "v": zeros(n_groups, batch, win, kv, hd),
            "conv": zeros(n_groups, 2, batch, cfg.conv_width - 1, w),
            "h": zeros(n_groups, 2, batch, w),
            "index": index,
        }
        if n_tail:
            cache["tail_conv"] = zeros(n_tail, batch, cfg.conv_width - 1, w)
            cache["tail_h"] = zeros(n_tail, batch, w)
        return cache
    if cfg.family == "xlstm":
        n_pairs = cfg.n_layers // 2
        nh = cfg.n_heads
        hd2 = cfg.d_model // nh
        d = cfg.d_model
        f32 = torch.float32
        return {
            "s_c": zeros(n_pairs, batch, d, dtype=f32),
            "s_n": zeros(n_pairs, batch, d, dtype=f32),
            "s_m": full(-1e30, n_pairs, batch, d),
            "m_C": zeros(n_pairs, batch, nh, hd2, hd2, dtype=f32),
            "m_n": zeros(n_pairs, batch, nh, hd2, dtype=f32),
            "m_m": full(-30.0, n_pairs, batch, nh),
            "index": index,
        }
    if cfg.family == "encdec":
        enc_len = max(max_len // cfg.enc_frames_ratio, 1)
        return {"k": zeros(cfg.n_layers, batch, max_len, kv, hd),
                "v": zeros(cfg.n_layers, batch, max_len, kv, hd),
                "enc_out": zeros(batch, enc_len, cfg.d_model),
                "index": index}
    raise ValueError(cfg.family)


def cache_logical(cfg: ModelConfig, head_sharded: bool = False
                  ) -> Dict[str, Tuple]:
    """Logical axes for each decode-state leaf.

    Default is seq-sharded cache (flash-decoding style -- works for every
    kv count). ``head_sharded`` prefers the kv-head axis (no cross-shard
    softmax combine) and is valid when n_kv % tp == 0 (perf lever for
    qwen2-moe/whisper-class archs)."""
    if cfg.family in ("dense", "moe"):
        kv = ((None, "batch", None, "kv_heads", None) if head_sharded
              else (None, "batch", "kv_seq", "kv_heads", None))
        return {"k": kv, "v": kv, "index": ()}
    if cfg.family == "griffin":
        kv = (None, "batch", "kv_seq", "kv_heads", None)
        d = {
            "k": kv, "v": kv,
            "conv": (None, None, "batch", None, "w_state"),
            "h": (None, None, "batch", "w_state"),
            "index": (),
        }
        n_tail = cfg.n_layers - 3 * (cfg.n_layers // 3)
        if n_tail:
            d["tail_conv"] = (None, "batch", None, "w_state")
            d["tail_h"] = (None, "batch", "w_state")
        return d
    if cfg.family == "xlstm":
        return {
            "s_c": (None, "batch", "w_state"), "s_n": (None, "batch", "w_state"),
            "s_m": (None, "batch", "w_state"),
            "m_C": (None, "batch", "heads", None, None),
            "m_n": (None, "batch", "heads", None),
            "m_m": (None, "batch", "heads"),
            "index": (),
        }
    if cfg.family == "encdec":
        kv = (None, "batch", "kv_seq", "kv_heads", None)
        return {"k": kv, "v": kv, "enc_out": ("batch", None, None), "index": ()}
    raise ValueError(cfg.family)


def shard_cache(cache: Tree, cfg: ModelConfig) -> Tree:
    """A decode state distributed by :func:`cache_logical` under the
    current sharding rules (its step index stays a plain tensor, alike on
    every rank)."""
    specs = cache_logical(cfg)
    return {k: v if k == "index" else shard_tree(v, specs[k])
            for k, v in cache.items()}


_XLSTM_STATE = (("s_c", "c"), ("s_n", "n"), ("s_m", "m"))
_MLSTM_STATE = (("m_C", "C"), ("m_n", "n"), ("m_m", "m"))


def _serving_supported(cfg: ModelConfig) -> None:
    """Raises for a configuration whose serving path is not written: one
    with per-layer windows, YaRN or the held experts' layer."""
    fields = [name for name, on in (
        ("full_every", cfg.full_every), ("yarn_factor", cfg.yarn_factor),
        ("experts_held/capacity_factor", cfg.held_experts)) if on]
    if fields:
        raise NotImplementedError(
            f"{cfg.name}: prefill and decode do not take "
            f"{', '.join(fields)}")


@torch.no_grad()
def prefill(params: Tree, cfg: ModelConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Tree]:
    """Process the prompt, build the decode state. Returns (last_logits
    (B, 1, V), cache); ``max_len`` reserves cache room for decoding.  Runs
    on the device of the parameters, without autograd."""
    _serving_supported(cfg)
    b, s = tokens.shape
    cache = init_cache(cfg, b, max(max_len or s, s), prefill=True,
                       device=params["embed"].device)
    if is_dtensor(params["embed"]):
        cache = shard_cache(cache, cfg)
    x = _embed(params, cfg, tokens)
    if cfg.family in ("dense", "moe"):
        for i, lp in enumerate(_layers(params, cfg, "layers",
                                       cfg.n_layers)):
            x, _, _, _ = _dense_block_seq(
                cfg, x, lp, positions, cache=(cache["k"][i], cache["v"][i]),
                cache_index=0, layer=i)
    elif cfg.family == "griffin":
        n_groups, n_tail = _n_groups(cfg)
        for i, gp in enumerate(_layers(params, cfg, "groups", n_groups)):
            x, s1, _ = _griffin_sub_seq(cfg, x, gp["rg1"], RGLRU, positions)
            x, s2, _ = _griffin_sub_seq(cfg, x, gp["rg2"], RGLRU, positions)
            x, _, _ = _griffin_sub_seq(cfg, x, gp["attn"], ATTN, positions,
                                       cache=(cache["k"][i], cache["v"][i]),
                                       cache_index=0)
            for j, st in enumerate((s1, s2)):
                cache["conv"][i, j] = st["conv"]
                cache["h"][i, j] = st["h"]
        for i, tp in enumerate(_layers(params, cfg, "tail", n_tail)):
            x, st, _ = _griffin_sub_seq(cfg, x, tp, RGLRU, positions)
            cache["tail_conv"][i] = st["conv"]
            cache["tail_h"][i] = st["h"]
    elif cfg.family == "xlstm":
        for i, pp in enumerate(_layers(params, cfg, "pairs",
                                       cfg.n_layers // 2)):
            x, s_state, m_state = _xlstm_pair_seq(cfg, x, pp,
                                                  return_state=True)
            for key, k in _XLSTM_STATE:
                cache[key][i] = s_state[k]
            for key, k in _MLSTM_STATE:
                cache[key][i] = m_state[k]
    elif cfg.family == "encdec":
        _need_frames(cfg, frames)
        enc_out = _encoder(params, cfg, frames)
        for i, lp in enumerate(_layers(params, cfg, "dec", cfg.n_layers)):
            x, _ = _dec_layer_seq(cfg, x, lp, enc_out,
                                  cache=(cache["k"][i], cache["v"][i]),
                                  cache_index=0)
        # the prompt's frames, which may be fewer than init_cache sized
        cache["enc_out"] = enc_out
    else:
        raise ValueError(cfg.family)
    cache["index"].fill_(s)
    return _logits(params, cfg, x[:, -1:], shard=False), cache


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
    _serving_supported(cfg)
    b = tokens.shape[0]
    index = cache["index"]
    x = _embed(params, cfg, tokens)
    pos = index.reshape(1, 1).expand(b, 1)
    if cfg.family in ("dense", "moe"):
        for i, lp in enumerate(_layers(params, cfg, "layers",
                                       cfg.n_layers)):
            x, _, _, _ = _dense_block_seq(
                cfg, x, lp, pos, cache=(cache["k"][i], cache["v"][i]),
                cache_index=index, layer=i)
    elif cfg.family == "griffin":
        x = _griffin_decode(params, cfg, cache, x, pos)
    elif cfg.family == "xlstm":
        for i, pp in enumerate(_layers(params, cfg, "pairs",
                                       cfg.n_layers // 2)):
            y, s_new = R.slstm_scan(
                pp["slstm"], L.rmsnorm(pp["ln_s"], x, cfg.norm_eps),
                state={k: cache[key][i] for key, k in _XLSTM_STATE})
            x = x + y
            y, m_new = R.mlstm_step(
                pp["mlstm"], cfg, L.rmsnorm(pp["ln_m"], x, cfg.norm_eps),
                {k: cache[key][i] for key, k in _MLSTM_STATE})
            x = x + y
            for key, k in _XLSTM_STATE:
                cache[key][i] = s_new[k]
            for key, k in _MLSTM_STATE:
                cache[key][i] = m_new[k]
    elif cfg.family == "encdec":
        for i, lp in enumerate(_layers(params, cfg, "dec", cfg.n_layers)):
            x, _ = _dec_layer_seq(cfg, x, lp, cache["enc_out"], positions=pos,
                                  cache=(cache["k"][i], cache["v"][i]),
                                  cache_index=index)
    else:
        raise ValueError(cfg.family)
    return _logits(params, cfg, x), dict(cache, index=index + 1)


def _griffin_decode(params: Tree, cfg: ModelConfig, cache: Tree,
                    x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The griffin family's decode step over its groups and tail, the
    attention layers against the ring-buffer cache."""
    b = x.shape[0]
    index = cache["index"]
    win = cache["k"].shape[2]
    slot = index % win
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
        L._write(ck, k, slot)  # in place, in each rank's block on DTensors
        L._write(cv, v, slot)
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
    for i, gp in enumerate(_layers(params, cfg, "groups", n_groups)):
        for j, name in enumerate(("rg1", "rg2")):
            st = {"conv": cache["conv"][i, j], "h": cache["h"][i, j]}
            x, st, _ = _griffin_sub_seq(cfg, x, gp[name], RGLRU, pos, state=st)
            cache["conv"][i, j] = st["conv"]
            cache["h"][i, j] = st["h"]
        x = attn_ring(gp["attn"], x, cache["k"][i], cache["v"][i])
    for i, tp in enumerate(_layers(params, cfg, "tail", n_tail)):
        st = {"conv": cache["tail_conv"][i], "h": cache["tail_h"][i]}
        x, st, _ = _griffin_sub_seq(cfg, x, tp, RGLRU, pos, state=st)
        cache["tail_conv"][i] = st["conv"]
        cache["tail_h"][i] = st["h"]
    return x
