"""Snowflake Arctic: 128-expert top-2 MoE with a parallel dense residual FFN
[hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='arctic-480b',
        family='moe',
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv=8,
        d_ff=4864,
        vocab=32000,
        n_experts=128,
        top_k=2,
        moe_d_ff=4864,
        dense_residual=True,
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return ModelConfig(
        name='arctic-480b-smoke',
        family='moe',
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=2,
        d_ff=96,
        vocab=512,
        n_experts=8,
        top_k=2,
        moe_d_ff=96,
        dense_residual=True,
    )
