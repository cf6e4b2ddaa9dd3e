"""Mellum2-12B-A2.5B: 28 layers of GQA attention (three sliding-window
layers, then one full-attention layer, YaRN on the full ones) and a
dropless 64-expert top-8 MoE [hf:JetBrains/Mellum2-12B-A2.5B-Instruct,
config.json].

Read from the published ``config.json``: hidden size 2,304, 32 query and 4
key/value heads of 128, ``layer_types`` L L L G with ``sliding_window``
1,024, every MLP sparse (``mlp_layer_types``) with 64 experts of width 896
(``moe_intermediate_size``), 8 a token, ``norm_topk_prob`` true, no shared
expert; rope theta 500,000 on both kinds, YaRN on the full layers (factor
16, ``original_max_position_embeddings`` 8,192, ``beta_fast`` 32,
``beta_slow`` 1, ``attention_factor`` 1.2772588722239782); RMSNorm eps
1e-6, no attention bias, an untied head, vocabulary 98,304.
``intermediate_size`` (7,168) is given as ``d_ff``; no layer uses it.

Departures: the config names no scoring function and no QK norm, so the
router is the port's float32 softmax over all the experts and there is no
QK norm; the layer is dropless (``capacity_factor`` 0); the MTP head the
model card mentions is not in the config and not modelled.  ``config()``
holds all 64 experts; the benchmark's cell holds 8 of them, one chip's
share of an eight-way expert-parallel layer (``experts_held``).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='mellum2-12b-a2.5b',
        family='moe',
        n_layers=28,
        d_model=2304,
        n_heads=32,
        n_kv=4,
        d_head=128,
        d_ff=7168,
        vocab=98304,
        n_experts=64,
        top_k=8,
        moe_d_ff=896,
        capacity_factor=0.0,
        rope_theta=500_000.0,
        window=1024,
        full_every=4,
        full_at=3,
        yarn_factor=16.0,
        yarn_original_max=8192,
        yarn_beta_fast=32.0,
        yarn_beta_slow=1.0,
        yarn_attention_factor=1.2772588722239782,
        norm_eps=1e-6,
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: one L L L G period
    at window 8, 16 experts of which 4 are held, top-4, YaRN with a small
    ``original_max``."""
    return ModelConfig(
        name='mellum2-12b-a2.5b-smoke',
        family='moe',
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv=2,
        d_head=16,
        d_ff=96,
        vocab=512,
        n_experts=16,
        top_k=4,
        moe_d_ff=32,
        experts_held=4,
        expert_offset=0,
        capacity_factor=0.0,
        rope_theta=500_000.0,
        window=8,
        full_every=4,
        full_at=3,
        yarn_factor=4.0,
        yarn_original_max=32,
        yarn_beta_fast=32.0,
        yarn_beta_slow=1.0,
        yarn_attention_factor=1.2772588722239782,
        norm_eps=1e-6,
    )
