"""Model configuration for every assigned architecture family (the JAX
package's fields and defaults, with torch dtypes)."""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

# block kinds used in hybrid layer patterns
ATTN = "attn"
RGLRU = "rglru"
SLSTM = "slstm"
MLSTM = "mlstm"


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

    # attention details
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE (t,h,w)
    window: int = 0  # sliding-window size (griffin local attention)

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
