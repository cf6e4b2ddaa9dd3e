"""Public entry points of the Metronome kernels, with device dispatch.

Each op takes host arrays (any float dtype; ``core`` builds float64), casts
them to the kernels' types here — float32, and uint8 for the 0/1 route
matrix — copies them to ``device`` once, and dispatches on the tensors'
device: on a CUDA device the hand-written kernel runs (or raises), on the
CPU its plain PyTorch version from :mod:`ref`.  Results come back as numpy
float32 arrays, as the JAX package's ops return them.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from .. import _device
from . import ref
from .metronome_fill import metronome_fill
from .metronome_score import (metronome_score_multilink,
                              metronome_score_multilink_batch,
                              metronome_score_pairwise)

Device = Union[str, torch.device]


def _to(x, dtype: np.dtype, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(dev)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


# ---------------------------------------------------------------------------
# metronome rotation scoring
# ---------------------------------------------------------------------------

def score_pairwise(base_demand, bank_a, bank_b, capacity: float,
                   device: Device = "cuda") -> np.ndarray:
    """Eq. 18 scores for every (rot_a, rot_b) pair; see core/rotation.py."""
    dev = _device.resolve(device)
    return _host(metronome_score_pairwise(
        _to(base_demand, np.float32, dev), _to(bank_a, np.float32, dev),
        _to(bank_b, np.float32, dev), float(capacity)))


def score_multilink(base_demand, bank_a, bank_b, capacities,
                    device: Device = "cuda") -> np.ndarray:
    """Joint (min-over-links) Eq. 18 scores for every rotation pair of two
    free jobs over stacked (L, R, S) per-link demand banks."""
    dev = _device.resolve(device)
    return _host(metronome_score_multilink(
        _to(base_demand, np.float32, dev), _to(bank_a, np.float32, dev),
        _to(bank_b, np.float32, dev), _to(capacities, np.float32, dev)))


def score_multilink_batch(base_demand, bank_a, bank_b, capacities,
                          device: Device = "cuda") -> np.ndarray:
    """Candidate-batched joint Eq. 18 scores: ONE launch over stacked
    (C, L, R, S) banks returning (C, Ra, Rb) — the Score phase's surviving
    candidates evaluated together."""
    dev = _device.resolve(device)
    return _host(metronome_score_multilink_batch(
        _to(base_demand, np.float32, dev), _to(bank_a, np.float32, dev),
        _to(bank_b, np.float32, dev), _to(capacities, np.float32, dev)))


# ---------------------------------------------------------------------------
# progressive-filling fluid solve
# ---------------------------------------------------------------------------

def progressive_fill_ref(demands, routes, caps,
                         device: Device = "cuda") -> np.ndarray:
    """The plain PyTorch fill on ``device`` — the fluid engine's
    ``backend='torch'`` path, never the kernel."""
    dev = _device.resolve(device)
    return _host(ref.progressive_fill_ref(
        _to(demands, np.float32, dev), _to(routes, np.uint8, dev),
        _to(caps, np.float32, dev)))


def progressive_fill(demands, routes, caps,
                     device: Device = "cuda") -> np.ndarray:
    """Batched progressive-fill rates (B, F) over (B, F, L) route matrices:
    the fill kernel on a CUDA device, its plain version on the CPU."""
    dev = _device.resolve(device)
    return _host(metronome_fill(
        _to(demands, np.float32, dev), _to(routes, np.uint8, dev),
        _to(caps, np.float32, dev)))
