"""A cell's inputs, made from ``--seed``: the weights and the token batches.

Both sides are given the same inputs: the program's training state is
built from :func:`make_weights`, and the reference draws the same tensors
again from the same seed.  Every weight leaf has a generator of its own,
seeded from the seed and the leaf's name, so that one leaf can be drawn
again alone: on the device, in one call, in the type it is trained in.
The batches are drawn on the host, as a data pipeline hands them to a
training loop, one generator a step.
"""
from __future__ import annotations

import hashlib
import importlib
from typing import Dict, List, Tuple, Union

import numpy as np
import torch

# (name, shape, std) or (name, shape, std, dtype name)
LeafSpec = Union[Tuple[str, Tuple[int, ...], float],
                 Tuple[str, Tuple[int, ...], float, str]]


def derived_seed(seed: int, *parts) -> int:
    """A 63-bit seed for one stream of the run, from the run's seed (any
    whole number) and the stream's name."""
    digest = hashlib.sha256(repr((int(seed),) + parts).encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def family(model: dict):
    """The module under ``families/`` that knows the model's layers."""
    return importlib.import_module(f"perfbench.families.{model['family']}")


def leaf_specs(model: dict) -> List[LeafSpec]:
    """(name, shape, std[, dtype]) of every weight, in the program's tree
    order; a std of 0 marks a norm scale, which starts at ones."""
    return family(model).leaf_specs(model)


def make_leaf(model: dict, seed: int, spec: LeafSpec,
              device: torch.device) -> torch.Tensor:
    """One weight leaf: std x a standard normal drawn on ``device`` in the
    spec's dtype, or the configuration's ``param_dtype`` where the spec
    names none (ones for a norm scale)."""
    name, shape, std = spec[:3]
    dtype = getattr(torch, spec[3] if len(spec) > 3 else model["param_dtype"])
    if std == 0.0:
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, "weight", name))
    leaf = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return leaf.mul_(std)


def make_weights(model: dict, seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """Every weight leaf by name."""
    return {spec[0]: make_leaf(model, seed, spec, device)
            for spec in leaf_specs(model)}


def make_batch(model: dict, traffic: dict, seed: int,
               step: int) -> Dict[str, np.ndarray]:
    """Step ``step``'s batch: ``seqs_per_step`` rows of ``seq`` token ids
    drawn uniformly over the vocabulary, and the next token of each as
    its label (int32, as the program's data pipeline gives them)."""
    rng = np.random.default_rng(derived_seed(seed, "batch", step))
    rows, seq = traffic["seqs_per_step"], traffic["seq"]
    ids = rng.integers(0, model["vocab"], size=(rows, seq + 1),
                       dtype=np.int32)
    return {"tokens": np.ascontiguousarray(ids[:, :-1]),
            "labels": np.ascontiguousarray(ids[:, 1:])}
