# Hand-written Hopper CUDA kernels for the compute hot-spots:
#   metronome_fill  — batched progressive-filling fluid solve
#   metronome_score — the Score phase's joint rotation score (Eq. 18)
#   flash_attention — attention forward of a fresh prompt (dense and griffin)
#                     and its gradient in training (flash_attention_bwd.cu)
#   rg_lru          — the RG-LRU recurrence of the griffin family
#   lm_head         — the LM head's float32 logits and their gradients on
#                     the tensor cores (no Pallas kernel: XLA's einsum);
#                     its differentiable entry is ops.lm_head
# Each has a plain PyTorch version in ref.py and a dispatching entry point
# in ops.py; CPU tensors take the plain version, CUDA tensors the kernel.
# The CUDA sources in csrc/ build on first use (repro_torch._cuda_build).
from . import ops, ref

__all__ = ["ops", "ref"]
