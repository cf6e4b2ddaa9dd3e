"""StarCoder2-15B dense GQA (kv=4), RoPE [arXiv:2402.19173]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='starcoder2-15b',
        family='dense',
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv=4,
        d_ff=24576,
        vocab=49152,
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return ModelConfig(
        name='starcoder2-15b-smoke',
        family='dense',
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=2,
        d_ff=128,
        vocab=512,
    )
