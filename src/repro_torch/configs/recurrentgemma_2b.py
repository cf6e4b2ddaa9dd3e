"""RecurrentGemma-2B (Griffin): RG-LRU + local attention 1:2, MQA
[arXiv:2402.19427]. Sub-quadratic -> runs long_500k."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='recurrentgemma-2b',
        family='griffin',
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv=1,
        d_ff=7680,
        vocab=256000,
        window=2048,
        lru_width=2560,
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return ModelConfig(
        name='recurrentgemma-2b-smoke',
        family='griffin',
        n_layers=6,
        d_model=64,
        n_heads=4,
        n_kv=1,
        d_ff=128,
        vocab=512,
        window=16,
        lru_width=64,
    )
