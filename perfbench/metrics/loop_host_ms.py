"""Host ms a step that the training loop (``launch/train.py``'s loop,
``runtime/comm_gate.py``) spends around the step: making and copying the
batch, the CommGate's wait and the reporter.  The loss's readback is left
out: it waits for the device to finish the step.  The benchmark's own
spans on the host clock, over the window's steps."""


def read(record):
    w = record["window"]
    host = sum(sum(w["parts"][p]) for p in ("batch", "gate", "report"))
    return host / w["steps"] * 1e3
