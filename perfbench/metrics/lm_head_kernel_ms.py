"""Device ms a step of the model's LM head on its kernels
(``kernels/lm_head.py``: the float32 logits of bf16 operands and their two
gradients): the kernels launched inside the program's span
``repro_torch.lm_head``, which the forward opens on the thread that runs
the step and the backward on autograd's device thread, under
``torch.profiler``.  None where the trace holds no such span (a program
whose head runs as float32 products)."""
from perfbench import program_spans


def read(record):
    return program_spans.span_ms(record, "repro_torch.lm_head")
