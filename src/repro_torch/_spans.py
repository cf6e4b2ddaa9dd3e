"""Named spans of the port's own work, on a profiler's clock.

``span(name)`` is a ``torch.profiler.record_function(name)`` while a
``torch.profiler`` (or the autograd profiler) records, and one shared null
context otherwise: nothing but a running profiler turns the spans on, and
off they cost one C call each.  A span lands in the profiler's trace as a
``user_annotation`` on its thread, on the clock of the kernels launched
inside it.  Every span of the port is named ``repro_torch.<...>``.
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that marks its body as span ``name`` while a profiler
    records."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
