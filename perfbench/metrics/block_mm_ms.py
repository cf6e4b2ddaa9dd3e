"""Device ms a step of every product (``aten::mm``/``bmm``) but the LM
head's: the blocks' projections and MLP (``models/layers.py``), forward,
recompute and backward, under ``torch.profiler``."""
from perfbench import trace_read


def read(record):
    return trace_read.products_ms(record, head=False)
