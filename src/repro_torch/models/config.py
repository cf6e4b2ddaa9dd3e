"""Model configuration for every assigned architecture family (the JAX
package's fields and defaults, with torch dtypes)."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

# block kinds used in hybrid layer patterns
ATTN = "attn"
RGLRU = "rglru"
SLSTM = "slstm"
MLSTM = "mlstm"


@dataclasses.dataclass(frozen=True)
class Yarn:
    """YaRN's rope parameters: the scale ``factor`` of the wavelengths
    past ``original_max`` positions, the ramp between ``beta_fast`` and
    ``beta_slow`` rotations, and the ``attention_factor`` on cos and
    sin."""

    factor: float
    original_max: int
    beta_fast: float
    beta_slow: float
    attention_factor: float


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | griffin | xlstm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    moe_ep_dispatch: bool = False  # EP-consistent dispatch (see moe._buf_axes)
    # the experts this chip holds of the router's ``n_experts``: the
    # ``experts_held`` from ``expert_offset`` on (0: all of them); with a
    # share, or with ``capacity_factor`` 0 (no capacity: nothing dropped),
    # ``moe.held_experts_block`` computes the layer
    experts_held: int = 0
    expert_offset: int = 0

    # attention details
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE (t,h,w)
    # sliding-window size: griffin's local attention, and the windowed
    # layers of dense and moe (``layer_window``)
    window: int = 0
    # dense and moe: layer i attends to all earlier positions where
    # i % full_every == full_at, and over ``window`` keys otherwise (0:
    # ``window`` on every layer)
    full_every: int = 0
    full_at: int = 0
    # YaRN rope on the full-attention layers (factor 0: none), as
    # ``transformers``' ``_compute_yarn_parameters`` defines it
    yarn_factor: float = 0.0
    yarn_original_max: int = 0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_attention_factor: float = 1.0

    # griffin / recurrent
    lru_width: int = 0
    conv_width: int = 4

    # encoder-decoder (whisper): encoder layer count; frontend is a stub
    n_enc_layers: int = 0
    enc_frames_ratio: int = 4  # encoder frames = seq_len // ratio

    # numerics & runtime
    bf16_grad_barrier: bool = False  # bf16 backward collectives (see layers)
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.bfloat16
    norm_eps: float = 1e-6
    attn_chunk: int = 1024
    remat: bool = True
    # 'nothing' recomputes everything (min memory, recomputes TP psums in
    # the backward); 'dots' saves matmul outputs (no psum recompute, more
    # memory) -- see EXPERIMENTS.md section Perf, arctic iteration 4
    remat_policy: str = "nothing"
    scan_layers: bool = True
    # lm-head logits are computed in f32 for loss stability
    logit_dtype: Any = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv

    def pattern(self) -> Tuple[str, ...]:
        """Per-layer temporal-mixing kind."""
        if self.family == "griffin":
            # Griffin: repeating (recurrent, recurrent, local attention)
            out = []
            for i in range(self.n_layers):
                out.append(ATTN if i % 3 == 2 else RGLRU)
            return tuple(out)
        if self.family == "xlstm":
            # alternating sLSTM / mLSTM blocks
            return tuple(SLSTM if i % 2 == 0 else MLSTM
                         for i in range(self.n_layers))
        return tuple(ATTN for _ in range(self.n_layers))

    def layer_window(self, i: int) -> int:
        """The attention window of dense or moe layer ``i`` (0: none)."""
        if self.full_every and i % self.full_every == self.full_at:
            return 0
        return self.window

    def layer_yarn(self, i: int) -> Optional["Yarn"]:
        """YaRN's parameters for layer ``i``'s rope: on each layer without
        a window, where ``yarn_factor`` is set; None for the plain rope."""
        if not self.yarn_factor or self.layer_window(i):
            return None
        return Yarn(self.yarn_factor, self.yarn_original_max,
                    self.yarn_beta_fast, self.yarn_beta_slow,
                    self.yarn_attention_factor)

    @property
    def held_experts(self) -> bool:
        """True where the expert layer holds a share of the experts or
        drops nothing (``moe.held_experts_block``)."""
        return self.n_experts > 0 and (self.experts_held > 0
                                       or self.capacity_factor == 0)

    @property
    def n_held(self) -> int:
        return self.experts_held or self.n_experts

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can decode at 500k context (SSM/hybrid/linear)."""
        return self.family in ("griffin", "xlstm")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'
    microbatch: int = 0  # global microbatch for grad accumulation (0 = auto)


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
