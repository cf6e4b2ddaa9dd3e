"""Llama-3-8B dense GQA, 128k vocab [arXiv:2407.21783]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='llama3-8b',
        family='dense',
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv=8,
        d_ff=14336,
        vocab=128256,
        rope_theta=500000.0,
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return ModelConfig(
        name='llama3-8b-smoke',
        family='dense',
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=2,
        d_ff=128,
        vocab=512,
        rope_theta=500000.0,
    )
