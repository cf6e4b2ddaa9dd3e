"""Device ms a step of the held experts' routing, dispatch and combine
(``models/moe.py``'s ``held_experts_block``: the router product, softmax,
top-k, the aux loss, the selection, the sort and the gather of the rows;
the gate weights and the sum back into the tokens): the kernels launched
inside the program's spans ``repro_torch.moe.route`` and
``repro_torch.moe.combine``, in the forward and in remat's recompute.  The
backward of the gathers and of the sum runs outside them and is the
step's backward's (``backward_ms``).  None where the trace holds neither
span."""
from perfbench import program_spans

SPANS = ("repro_torch.moe.route", "repro_torch.moe.combine")


def read(record):
    parts = [program_spans.span_ms(record, name) for name in SPANS]
    if all(p is None for p in parts):
        return None
    return sum(p for p in parts if p is not None)
