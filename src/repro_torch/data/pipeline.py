"""Deterministic synthetic LM data pipeline.

Produces packed next-token batches from a seeded Markov-ish token stream
(deterministic per (seed, step) — a restart resumes exactly where it left
off, which the checkpoint/resume tests rely on). A background thread
prefetches ahead of the training loop.  Pure numpy, the JAX package's
module with the same ``SeedSequence([seed, step])`` streams, so both
packages draw the same batches.  ``make_batch_specs`` gives the inputs of a
shape cell as meta tensors (the JAX package's ``ShapeDtypeStruct``s).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..models.config import ModelConfig, ShapeConfig


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for a given step (restart-safe)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        # zipf-ish marginal + local repetition gives a learnable signal
        base = rng.zipf(1.3, size=(self.global_batch, self.seq_len + 1))
        tokens = (base % (self.vocab - 2)) + 1
        rep = rng.random((self.global_batch, self.seq_len + 1)) < 0.3
        tokens[:, 1:] = np.where(rep[:, 1:], tokens[:, :-1], tokens[:, 1:])
        tokens = tokens.astype(np.int32)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:].copy()}


def packed_batch_iterator(ds: SyntheticLM, start_step: int = 0,
                          prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
    """Host-side prefetching iterator."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            q.put(ds.batch_at(step))
            step += 1

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()


def make_batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                     batch_override: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins (shapes and dtypes, no storage) for every
    model input of a shape cell.

    This is the single source of truth consumed by the dry-run and the
    serving/training step builders.
    """
    b = batch_override or shape.global_batch
    s = shape.seq_len
    i32 = torch.int32

    def spec(*dims, dtype=i32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "train":
        specs = {"tokens": spec(b, s), "labels": spec(b, s)}
    elif shape.kind == "prefill":
        specs = {"tokens": spec(b, s)}
    else:  # decode
        specs = {"tokens": spec(b, 1)}
    if cfg.family == "encdec" and shape.kind != "decode":
        specs["frames"] = spec(b, max(s // cfg.enc_frames_ratio, 1),
                               cfg.d_model, dtype=torch.float32)
    if cfg.mrope_sections and shape.kind != "decode":
        specs["positions"] = spec(3, b, s)
    return specs
