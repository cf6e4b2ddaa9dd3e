"""InternLM2-20B dense GQA [arXiv:2403.17297]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='internlm2-20b',
        family='dense',
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv=8,
        d_ff=16384,
        vocab=92544,
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return ModelConfig(
        name='internlm2-20b-smoke',
        family='dense',
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=2,
        d_ff=128,
        vocab=512,
    )
