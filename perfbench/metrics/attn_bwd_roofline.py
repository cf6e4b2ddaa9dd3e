"""The attention backward's share of its roofline, in %: the bound of
each call into ``kernels/ops.flash_attention_bwd`` (10 D a pair, the
algorithm's five products) over the device time of every kernel launched
inside the benchmark's span around that entry."""
from perfbench import trace_read


def read(record):
    return trace_read.roofline_pct(record, backward=True)
