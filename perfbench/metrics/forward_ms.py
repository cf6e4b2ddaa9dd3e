"""Device ms a step of the model's forward (each micro-batch's slice and
``models/model.py``'s ``loss_fn``): the kernels launched inside the
program's span ``repro_torch.train_step.forward`` (``runtime/steps.py``),
under ``torch.profiler``."""
from perfbench import program_spans


def read(record):
    return program_spans.span_ms(record, "repro_torch.train_step.forward")
