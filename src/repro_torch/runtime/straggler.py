"""Straggler mitigation = the paper's drift monitor applied to step times.

A slow host manifests exactly like communication drift: iteration times
exceed the baseline by a factor. The SAME windowed A_T/O_T rule the
stop-and-wait controller uses for traffic drift (section III-C) doubles as
job-level straggler detection; on trip, the runner triggers the elastic
re-mesh path instead of a phase realign (``runtime/elastic.py``).
Pure Python, the JAX package's module as it is.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, List, Optional


@dataclasses.dataclass
class StragglerEvent:
    step: int
    iter_time_s: float
    baseline_s: float


class StragglerMonitor:
    """Windowed A_T/O_T rule over training-step wall times.

    Baseline = EMA of healthy steps; a trip requires more than ``o_t`` of
    the last ``window`` steps above ``a_t x baseline`` (the controller's
    MONITOR_WINDOW semantics, section III-C)."""

    def __init__(self, a_t: float = 1.3, o_t: int = 5, window: int = 10,
                 on_straggler: Optional[Callable[[StragglerEvent], None]] = None):
        self.a_t = a_t
        self.o_t = o_t
        self._hist: collections.deque = collections.deque(maxlen=window)
        self._baseline_s: Optional[float] = None
        self._alpha = 0.1  # EMA for the healthy baseline
        self._step = 0
        self.events: List[StragglerEvent] = []
        self.on_straggler = on_straggler

    def report(self, iter_time_s: float) -> bool:
        """Returns True when the straggler rule trips this step."""
        self._step += 1
        if self._baseline_s is None:
            self._baseline_s = iter_time_s
            return False
        if iter_time_s <= self.a_t * self._baseline_s:
            self._baseline_s = ((1 - self._alpha) * self._baseline_s
                                + self._alpha * iter_time_s)
        self._hist.append(iter_time_s)
        n_slow = sum(1 for t in self._hist
                     if t > self.a_t * self._baseline_s)
        if n_slow <= self.o_t:
            return False
        self._hist.clear()
        ev = StragglerEvent(self._step, iter_time_s, self._baseline_s)
        self.events.append(ev)
        if self.on_straggler is not None:
            self.on_straggler(ev)
        return True
