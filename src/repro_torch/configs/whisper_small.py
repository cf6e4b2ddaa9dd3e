"""Whisper-small backbone: bidirectional encoder over STUB frame embeddings
(conv frontend stubbed per assignment) + causal decoder w/ cross-attention
[arXiv:2212.04356]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='whisper-small',
        family='encdec',
        n_layers=12,
        n_enc_layers=12,
        d_model=768,
        n_heads=12,
        n_kv=12,
        d_ff=3072,
        vocab=51865,
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return ModelConfig(
        name='whisper-small-smoke',
        family='encdec',
        n_layers=2,
        n_enc_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=4,
        d_ff=128,
        vocab=512,
    )
