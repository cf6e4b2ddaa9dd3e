"""Hopper CUDA kernel for the batched progressive-filling fluid solve.

Replaces the Pallas TPU kernel ``src/repro/kernels/metronome_fill.py``
(``_fill_kernel``, launched by ``metronome_fill``).  ``core/fluid.py``
reduces max-min fair rate sharing to a fixed point over a (flows x links)
demand/route matrix; this kernel runs that fixed point for a whole batch
of fill problems.  It is the ``backend='kernel'`` path of the fluid engine:
the event loop's per-tick refill of dirty affinity components and the
trace corpus.

What bounds it on the H100 is the round loop, not bytes or operations: a
64-problem bucket of the trace corpus needs well under a microsecond of
either, while every round is a chain of barriers and reductions.  The
source (``csrc/metronome_fill.cu``) keeps one water level per problem in
place of a rate per flow, routes and saturated links as bitmasks, and link
counts that are decremented when a flow freezes, so a round costs two
block barriers; problems of at most 32 flows and 32 links take one warp
each, with no block barrier at all.  It leaves the loop as soon as the
problem drains and matches the plain version bit for bit.  Padding is
neutral as on the TPU: zero-demand flows never activate, zero-route
unit-capacity links never saturate.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import torch

from .. import _cuda_build
from .ref import progressive_fill_ref

# (max flows, opt-in shared-memory limit) by CUDA device index; thread
# sweeps reach this wrapper through the fluid engine's 'kernel' backend
_LOCK = threading.Lock()
_LIMITS: Dict[int, Tuple[int, int]] = {}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.metronome_fill_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.metronome_fill_smem_limit.argtypes = []
    lib.metronome_fill_smem_limit.restype = ctypes.c_longlong
    lib.metronome_fill_state_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.metronome_fill_state_bytes.restype = ctypes.c_longlong
    lib.metronome_fill_max_flows.argtypes = []
    lib.metronome_fill_max_flows.restype = ctypes.c_int
    lib.metronome_fill_error.argtypes = [ctypes.c_int]
    lib.metronome_fill_error.restype = ctypes.c_char_p
    return lib


def metronome_fill(demands: torch.Tensor, routes: torch.Tensor,
                   caps: torch.Tensor) -> torch.Tensor:
    """Batched progressive-fill rates (B, F): one warp per problem of at
    most 32 flows and 32 links, else one CTA per problem.

    ``demands`` (B, F) float32, ``routes`` (B, F, L) uint8 0/1, ``caps``
    (B, L) float32, contiguous and on one device.  CPU tensors take the
    plain PyTorch version (:func:`~repro_torch.kernels.ref.progressive_fill_ref`);
    CUDA tensors launch the kernel, or raise."""
    if not demands.is_cuda:
        return progressive_fill_ref(demands, routes, caps)
    b, f = demands.shape
    if routes.dim() != 3 or routes.shape[:2] != (b, f):
        raise ValueError(f"routes must be (B, F, L) = ({b}, {f}, L), "
                         f"got {tuple(routes.shape)}")
    l = routes.shape[2]
    _cuda_build.check_tensors("metronome_fill", demands.device, (
        ("demands", demands, torch.float32, (b, f)),
        ("routes", routes, torch.uint8, (b, f, l)),
        ("caps", caps, torch.float32, (b, l))))
    out = torch.empty_like(demands)
    if b == 0 or f == 0:
        return out
    if l == 0:
        raise ValueError("metronome_fill needs at least one link")
    with torch.cuda.device(demands.device):
        lib = _cuda_build.load("metronome_fill", _bind)
        index = demands.device.index
        with _LOCK:
            if index not in _LIMITS:
                _LIMITS[index] = (lib.metronome_fill_max_flows(),
                                  lib.metronome_fill_smem_limit())
            max_f, limit = _LIMITS[index]
        if f > max_f:
            raise ValueError(f"metronome_fill: takes at most {max_f} flows, "
                             f"got F={f}")
        need = lib.metronome_fill_state_bytes(f, l)
        if limit >= 0 and need > limit:
            raise ValueError(
                f"metronome_fill: {f} flows x {l} links need {need} bytes of "
                f"shared memory per problem, the device allows {limit}")
        rc = lib.metronome_fill_launch(
            demands.data_ptr(), routes.data_ptr(), caps.data_ptr(),
            out.data_ptr(), b, f, l, torch.cuda.current_stream().cuda_stream)
        _cuda_build.check_launch("metronome_fill", rc, lib.metronome_fill_error)
    metronome_fill.launches += 1
    return out


metronome_fill.launches = 0
