"""The program's spans in a traced run: the device time launched under each
of ``repro_torch``'s spans (``src/repro_torch/_spans.py``).

While ``torch.profiler`` records, the train step (``runtime/steps.py``)
opens ``repro_torch.train_step.forward``, ``.backward`` and
``.accumulate``; AdamW (``optim/adamw.py``) opens
``repro_torch.adamw.update``.  All of them are opened by the thread that
runs the step.  The backward's kernels are launched by autograd's device
thread while that thread waits in ``torch.autograd.grad``, where no span
of the program is open.

Both readings take the record ``trace_read.read`` makes: its ``spans_s``
holds the device time launched inside each span on the span's own thread,
which is all of a span's for the forward, the gradient sum and AdamW.
"""
from __future__ import annotations

from typing import Optional

from . import trace_read

STEP_SPANS = "repro_torch.train_step."
BACKWARD_SPAN = STEP_SPANS + "backward"


def span_ms(record: dict, name: str) -> Optional[float]:
    """Device ms a step, over the traced steps, launched inside span
    ``name`` on its own thread; None where the trace placed none there."""
    tr = record["trace"]
    device_s = tr["spans_s"].get(name)
    return None if device_s is None else device_s / tr["steps"] * 1e3


def backward_ms(record: dict) -> Optional[float]:
    """Device ms a step of the backward, by a residual: every placed
    launch (one whose host call the trace holds), less those the loop's
    thread made inside the benchmark's loop spans, plus those it made
    inside the program's backward span.  What remains is the launches of
    every other thread and of the loop's thread outside its loop spans.
    That is the backward's only where autograd's device thread is the one
    other thread that launches and the loop's thread launches nothing
    between its loop spans, as in the benchmark's traced steps.  None
    where the trace holds none of the train step's spans."""
    tr = record["trace"]
    spans = tr["spans_s"]
    if not any(name.startswith(STEP_SPANS) for name in spans):
        return None
    placed = sum(tr["kernels_s"].values()) - tr["unplaced_s"]
    loop = sum(s for name, s in spans.items()
               if name.startswith(trace_read.LOOP_SPAN))
    return (placed - loop + spans.get(BACKWARD_SPAN, 0.0)) / tr["steps"] \
        * 1e3
