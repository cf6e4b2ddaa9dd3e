"""Qwen1.5-MoE-A2.7B: 4 shared + 60 routed experts, top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='qwen2-moe-a2.7b',
        family='moe',
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv=16,
        d_ff=1408,
        vocab=151936,
        n_experts=60,
        top_k=4,
        n_shared=4,
        moe_d_ff=1408,
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return ModelConfig(
        name='qwen2-moe-a2.7b-smoke',
        family='moe',
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=4,
        d_ff=64,
        vocab=512,
        n_experts=6,
        top_k=2,
        n_shared=2,
        moe_d_ff=64,
    )
