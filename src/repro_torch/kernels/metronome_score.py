"""Hopper CUDA kernel for Metronome's rotation-scheme scoring (Eq. 18).

Replaces the three Pallas TPU kernels of ``src/repro/kernels/metronome_score.py``
with one CUDA kernel (``csrc/metronome_score.cu``) and three wrappers of
the reference's names:

  * :func:`metronome_score_multilink_batch` — ``_multilink_batch_kernel``:
    joint scores (C, Ra, Rb) of every surviving candidate placement of a
    pod in one launch, the min over each candidate's links of Eq. 18;
  * :func:`metronome_score_multilink` — ``_multilink_kernel``: the same
    for one candidate, the C = 1 launch;
  * :func:`metronome_score_pairwise` — ``_score_kernel``: one link with a
    scalar capacity, the C = 1, L = 1 launch.

What bounds it on the H100 is operations: an add, a max and an add per
(candidate, a, b, link, slot) term on inputs read once.  A block owns one
candidate and a 24 x 24 tile of rotation pairs, stages ``base + A`` and
``B - cap`` in shared memory by 16-byte loads, and each thread keeps a
3 x 3 micro-tile of excess sums in registers; the links are split across
up to four thread groups, so even one candidate keeps 9 blocks of 8 warps
busy.  The slot axis keeps its true length (S = 72 = ``DI_PRE``,
unrolled; the TPU padded it to 128 lanes), every max propagates NaN as the
plain version's do, and zero-demand unit-capacity padding links score
exactly 100.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict

import torch

from .. import _cuda_build
from .ref import (metronome_score_multilink_batch_ref,
                  metronome_score_multilink_ref, metronome_score_ref)

# largest slot count the kernel takes, by CUDA device index; thread sweeps
# reach the wrappers through the planner's 'kernel' backend
_LOCK = threading.Lock()
_MAX_SLOTS: Dict[int, int] = {}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.metronome_score_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.metronome_score_max_slots.argtypes = []
    lib.metronome_score_max_slots.restype = ctypes.c_longlong
    lib.metronome_score_error.argtypes = [ctypes.c_int]
    lib.metronome_score_error.restype = ctypes.c_char_p
    return lib


def _launch(name: str, base: torch.Tensor, bank_a: torch.Tensor,
            bank_b: torch.Tensor, caps: torch.Tensor) -> torch.Tensor:
    """Check the (C,L,S), (C,L,Ra,S), (C,L,Rb,S), (C,L) float32 operands
    and launch the score kernel into a fresh (C, Ra, Rb) output."""
    if base.dim() != 3 or bank_a.dim() != 4 or bank_b.dim() != 4:
        raise ValueError(f"{name}: expected (C,L,S), (C,L,Ra,S), (C,L,Rb,S) "
                         f"operands, got {tuple(base.shape)}, "
                         f"{tuple(bank_a.shape)}, {tuple(bank_b.shape)}")
    c, l, s = base.shape
    ra, rb = bank_a.shape[2], bank_b.shape[2]
    _cuda_build.check_tensors(name, base.device, (
        ("base_demand", base, torch.float32, (c, l, s)),
        ("bank_a", bank_a, torch.float32, (c, l, ra, s)),
        ("bank_b", bank_b, torch.float32, (c, l, rb, s)),
        ("capacities", caps, torch.float32, (c, l))))
    if min(c, l, s) < 1:
        raise ValueError(f"{name}: empty candidate, link or slot axis "
                         f"(C={c}, L={l}, S={s})")
    out = torch.empty((c, ra, rb), dtype=torch.float32, device=base.device)
    if ra == 0 or rb == 0:
        return out
    with torch.cuda.device(base.device):
        lib = _cuda_build.load("metronome_score", _bind)
        index = base.device.index
        with _LOCK:
            if index not in _MAX_SLOTS:
                _MAX_SLOTS[index] = lib.metronome_score_max_slots()
            max_slots = _MAX_SLOTS[index]
        if 0 <= max_slots < s:
            raise ValueError(f"{name}: supports S <= {max_slots}, got S={s}")
        rc = lib.metronome_score_launch(
            base.data_ptr(), bank_a.data_ptr(), bank_b.data_ptr(),
            caps.data_ptr(), out.data_ptr(), c, l, ra, rb, s,
            torch.cuda.current_stream().cuda_stream)
        _cuda_build.check_launch(name, rc, lib.metronome_score_error)
    return out


def metronome_score_multilink_batch(base_demand: torch.Tensor,
                                    bank_a: torch.Tensor,
                                    bank_b: torch.Tensor,
                                    capacities: torch.Tensor) -> torch.Tensor:
    """Joint scores (C, Ra, Rb) for EVERY candidate in one launch.

    ``base_demand`` (C, L, S), ``bank_a`` (C, L, Ra, S), ``bank_b``
    (C, L, Rb, S), ``capacities`` (C, L), float32, contiguous, one device.
    CPU tensors take the plain PyTorch version; CUDA tensors launch."""
    if not base_demand.is_cuda:
        return metronome_score_multilink_batch_ref(base_demand, bank_a,
                                                   bank_b, capacities)
    out = _launch("metronome_score_multilink_batch", base_demand, bank_a,
                  bank_b, capacities)
    metronome_score_multilink_batch.launches += 1
    return out


def metronome_score_multilink(base_demand: torch.Tensor,
                              bank_a: torch.Tensor, bank_b: torch.Tensor,
                              capacities: torch.Tensor) -> torch.Tensor:
    """Joint scores (Ra, Rb): min over links of Eq. 18 for every rotation
    pair of two free jobs.  ``base_demand`` (L, S), ``bank_a`` (L, Ra, S),
    ``bank_b`` (L, Rb, S), ``capacities`` (L,); the C = 1 launch."""
    if not base_demand.is_cuda:
        return metronome_score_multilink_ref(base_demand, bank_a, bank_b,
                                             capacities)
    out = _launch("metronome_score_multilink", base_demand[None],
                  bank_a[None], bank_b[None], capacities[None])
    metronome_score_multilink.launches += 1
    return out[0]


def metronome_score_pairwise(base_demand: torch.Tensor, bank_a: torch.Tensor,
                             bank_b: torch.Tensor,
                             capacity: float) -> torch.Tensor:
    """Scores (Ra, Rb) for every rotation pair of two free tasks on one
    link: ``base_demand`` (S,), ``bank_a`` (Ra, S), ``bank_b`` (Rb, S);
    the C = 1, L = 1 launch."""
    if not base_demand.is_cuda:
        return metronome_score_ref(base_demand, bank_a, bank_b, capacity)
    caps = torch.full((1, 1), float(capacity), dtype=torch.float32,
                      device=base_demand.device)
    out = _launch("metronome_score_pairwise", base_demand[None, None],
                  bank_a[None, None], bank_b[None, None], caps)
    metronome_score_pairwise.launches += 1
    return out[0]


metronome_score_multilink_batch.launches = 0
metronome_score_multilink.launches = 0
metronome_score_pairwise.launches = 0
