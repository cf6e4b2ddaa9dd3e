"""The attention forward's share of its roofline, in %: the bound of
each call into ``kernels/ops.flash_attention`` during the traced steps
(``workcount.attention_bound_s``, counted from the call's shapes) over
the device time of every kernel launched inside the benchmark's span
around that entry."""
from perfbench import trace_read


def read(record):
    return trace_read.roofline_pct(record, backward=False)
