"""Elastic scaling & fault tolerance: re-mesh on device loss, resume (the
JAX package's ``runtime/elastic.py``).

On real hardware, device failure surfaces as a collective timeout; here the
manager is driven by an explicit list of healthy ranks (tests mask ranks).
Policy: shrink the data axis to the largest power-of-two that the surviving
rank count supports while keeping the model axis intact (tensor-parallel
groups must stay whole), then restore state from the latest checkpoint and
continue -- the data pipeline is (seed, step)-deterministic so no data is
replayed or skipped.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch

from ..checkpoint import CheckpointManager


@dataclasses.dataclass
class ElasticDecision:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    dropped_hosts: int
    global_batch_scale: float  # <1 when the data axis shrank


def plan_remesh(n_healthy: int, model_parallel: int,
                axis_names: Tuple[str, ...] = ("data", "model")
                ) -> Optional[ElasticDecision]:
    """Largest power-of-two data axis that fits the healthy devices."""
    if n_healthy < model_parallel:
        return None  # cannot even form one TP group
    data = 1
    while data * 2 * model_parallel <= n_healthy:
        data *= 2
    return ElasticDecision(
        mesh_shape=(data, model_parallel),
        axis_names=axis_names,
        dropped_hosts=n_healthy - data * model_parallel,
        global_batch_scale=1.0,  # caller rescales batch/n_micro
    )


def build_mesh(ranks: Sequence[int], decision: ElasticDecision,
               device: Union[str, torch.device] = "cuda"):
    """A DeviceMesh over the first ranks of ``ranks`` (the surviving ones,
    of the default process group) in the decision's shape and axes."""
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for d in decision.mesh_shape:
        n *= d
    mesh = torch.tensor(list(ranks)[:n], dtype=torch.int64).reshape(
        decision.mesh_shape)
    return DeviceMesh(torch.device(device).type, mesh,
                      mesh_dim_names=decision.axis_names)


class FaultTolerantRunner:
    """Orchestrates detect -> remesh -> restore -> resume."""

    def __init__(self, ckpt: CheckpointManager, model_parallel: int,
                 device: Union[str, torch.device] = "cuda"):
        self.ckpt = ckpt
        self.model_parallel = model_parallel
        self.device = device
        self.events: List[str] = []

    def on_failure(self, healthy_ranks: Sequence[int], like_state):
        decision = plan_remesh(len(healthy_ranks), self.model_parallel)
        if decision is None:
            self.events.append("unrecoverable: not enough devices for TP")
            raise RuntimeError("not enough healthy devices")
        mesh = build_mesh(healthy_ranks, decision, self.device)
        state, step, extra = self.ckpt.restore_latest(like_state)
        self.events.append(
            f"remeshed to {decision.mesh_shape}, resumed at step {step}")
        return mesh, state, step, decision
