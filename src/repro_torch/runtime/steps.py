"""serve_step / prefill_step builders (the serving part of the JAX
package's ``runtime/steps.py``; the train step waits for ROADMAP A14)."""
from __future__ import annotations

from typing import Callable

from ..models import decode_step, prefill
from ..models.config import ModelConfig


def build_serve_step(cfg: ModelConfig) -> Callable:
    """Returns serve_step(params, cache, tokens) -> (logits, cache) — one
    decode step against the KV cache / recurrent state."""

    def serve_step(params, cache, tokens):
        return decode_step(params, cfg, cache, tokens)

    return serve_step


def build_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(params, batch):
        return prefill(params, cfg, batch["tokens"],
                       positions=batch.get("positions"))
    return prefill_step
