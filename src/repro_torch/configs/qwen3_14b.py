"""Qwen3-14B dense GQA with qk-norm [hf:Qwen/Qwen3-8B family]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='qwen3-14b',
        family='dense',
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv=8,
        d_ff=17408,
        vocab=151936,
        qk_norm=True,
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return ModelConfig(
        name='qwen3-14b-smoke',
        family='dense',
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=2,
        d_ff=128,
        vocab=512,
        qk_norm=True,
    )
