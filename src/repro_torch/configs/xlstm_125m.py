"""xLSTM-125M: alternating sLSTM / mLSTM blocks [arXiv:2405.04517].
Sub-quadratic -> runs long_500k."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='xlstm-125m',
        family='xlstm',
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv=4,
        d_ff=0,
        vocab=50304,
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return ModelConfig(
        name='xlstm-125m-smoke',
        family='xlstm',
        n_layers=4,
        d_model=64,
        n_heads=2,
        n_kv=2,
        d_ff=0,
        vocab=512,
    )
