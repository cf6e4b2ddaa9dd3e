"""Device ms a step of the model's backward (``torch.autograd.grad`` over
``models/``, the remat recompute included): the kernels launched inside
the program's span ``repro_torch.train_step.backward``
(``runtime/steps.py``) and by autograd's device thread, which launches
only there, under ``torch.profiler``."""
from perfbench import program_spans


def read(record):
    return program_spans.backward_ms(record)
