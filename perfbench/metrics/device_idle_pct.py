"""The device's idle share over the traced steps, in %: 1 - the time in
which some kernel or copy ran (``torch.profiler``) over their wall time."""


def read(record):
    tr = record["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["wall_s"])
