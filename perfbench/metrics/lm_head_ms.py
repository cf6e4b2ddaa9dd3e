"""Device ms a step of the model's float32 LM head (``models/model.py``):
the products (``aten::mm``/``bmm``) with a vocabulary-sized dimension,
forward and backward, under ``torch.profiler``."""
from perfbench import trace_read


def read(record):
    return trace_read.products_ms(record, head=True)
