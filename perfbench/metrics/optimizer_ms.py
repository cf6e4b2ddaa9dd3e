"""Device ms a step of AdamW (``optim/adamw.adamw_update``: the global
norm, the clip, the schedule, the moments and the parameters): the kernels
launched inside the program's span ``repro_torch.adamw.update``, under
``torch.profiler``."""
from perfbench import program_spans


def read(record):
    return program_spans.span_ms(record, "repro_torch.adamw.update")
