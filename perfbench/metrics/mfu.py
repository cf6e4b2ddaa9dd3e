"""The train step's (``runtime/steps.build_train_step``) model FLOPs a
step (``workcount.train_step_flops``: no remat) over the window's mean
step time and the chip's bf16 peak, in %."""
from perfbench import workcount


def read(record):
    w = record["window"]
    step_s = w["seconds"] / w["steps"]
    return 100.0 * record["step_flops"] / step_s / workcount.PEAK_BF16_FLOPS
