"""Device ms a step of the float32 gradient sum over the micro-batches
(``runtime/steps.py``: its buffers, the adds, the loss sums, the
division): the kernels launched inside the program's span
``repro_torch.train_step.accumulate``, under ``torch.profiler``."""
from perfbench import program_spans


def read(record):
    return program_spans.span_ms(record,
                                 "repro_torch.train_step.accumulate")
