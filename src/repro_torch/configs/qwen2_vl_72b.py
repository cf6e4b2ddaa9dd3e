"""Qwen2-VL-72B language backbone with M-RoPE (t/h/w sections); the vision
patch frontend is a STUB — input_specs() supplies patch position ids
[arXiv:2409.12191]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='qwen2-vl-72b',
        family='dense',
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv=8,
        d_ff=29568,
        vocab=152064,
        mrope_sections=(16, 24, 24),
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return ModelConfig(
        name='qwen2-vl-72b-smoke',
        family='dense',
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=2,
        d_ff=128,
        vocab=512,
        mrope_sections=(4, 2, 2),
    )
