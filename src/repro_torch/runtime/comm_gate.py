"""Metronome actuators inside the training loop.

``CommGate`` delays entry into the synchronization (gradient collective)
phase by the job's assigned time-shift — the accelerator-side equivalent of
the paper's pod pause (DESIGN.md section 2): a training job cannot be preempted
mid-step cheaply, so TDM alignment is enforced at the step boundary.

``IterationReporter`` is the modified-DDP/DeepSpeed shim: it feeds per-step
wall time to the stop-and-wait controller and applies any realign actions
(pauses) the controller returns.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

from repro_torch.core.controller import RealignAction, StopAndWaitController


class CommGate:
    """Gates the communication phase of each step to its assigned offset."""

    def __init__(self, controller: Optional[StopAndWaitController], job: str,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.controller = controller
        self.job = job
        self.clock = clock
        self.sleep = sleep
        self.total_delay_s = 0.0

    def wait_for_slot(self) -> float:
        """Call immediately before the gradient collective. Sleeps until the
        next assigned communication slot; returns the delay applied (s)."""
        if self.controller is None:
            return 0.0
        align = self.controller.job_alignment(self.job)
        if align is None:
            return 0.0
        offset_ms, period_ms = align
        now_ms = self.clock() * 1e3
        delay_ms = (offset_ms - (now_ms % period_ms)) % period_ms
        # only delay when we're meaningfully off-slot (avoid micro-sleeps)
        if delay_ms > 1.0 and delay_ms < period_ms * 0.95:
            self.sleep(delay_ms / 1e3)
            self.total_delay_s += delay_ms / 1e3
            return delay_ms / 1e3
        return 0.0


class IterationReporter:
    """Reports step wall-times to the controller; applies pause actions."""

    def __init__(self, controller: Optional[StopAndWaitController], job: str,
                 priority: int,
                 sleep: Callable[[float], None] = time.sleep):
        self.controller = controller
        self.job = job
        self.priority = priority
        self.sleep = sleep
        self.pauses_applied = 0
        if controller is not None:
            controller._priorities.setdefault(job, priority)

    def report(self, iter_time_s: float) -> List[RealignAction]:
        if self.controller is None:
            return []
        actions = self.controller.report_iteration(self.job, iter_time_s * 1e3)
        for act in actions:
            if act.job == self.job:
                align = self.controller.job_alignment(self.job)
                if align is not None:
                    _, period_ms = align
                    self.sleep(min(period_ms, 50.0) / 1e3)
                    self.pauses_applied += 1
        return actions
