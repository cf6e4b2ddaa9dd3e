"""Device ms a step of the held experts' grouped products and SwiGLU
(``models/moe.py``'s ``_HeldExperts``: the forward, remat's recompute and
the backward's dX and dW): the kernels launched inside the program's span
``repro_torch.moe.experts``, which the forward opens on the thread that
runs the step and the backward on autograd's device thread, under
``torch.profiler``.  None where the trace holds no such span (a program
without the held experts' layer)."""
from perfbench import program_spans


def read(record):
    return program_spans.span_ms(record, "repro_torch.moe.experts")
