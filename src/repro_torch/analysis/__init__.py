"""metrolint for the port: static invariant checks on ``src/repro_torch/``.

The port's correctness hinges on contracts nothing else enforces
mechanically: epoch counters that must advance on every demand/capacity
mutation, CUDA kernels that must keep a plain PyTorch twin in ``ref.py``
and a parity test on the card, modules the test suite pins bit-for-bit
that must stay free of nondeterminism hazards, content-keyed caches whose
key functions must cover every input field, and module-level state
reachable from ``sweep(mode="thread")`` worker threads.  Run it as
``PYTHONPATH=src python -m repro_torch.analysis``.

It reads only ``src/repro_torch/**`` and ``tests/test_torch_*.py``, and
imports nothing of the JAX package.  Deliberate deviations are recorded in
``metrolint_torch.baseline.json`` at the repo root; every suppression
carries a reason and the CLI fails on any finding not in the baseline (and
on baseline entries that no longer match anything, so the file cannot
rot).
"""
from .core import (Finding, Repo, all_checks, apply_baseline, load_baseline,
                   run_checks, write_baseline)

# the check modules self-register on import
from . import checks as _checks  # noqa: F401  (import-time registration)

__all__ = [
    "Finding",
    "Repo",
    "all_checks",
    "apply_baseline",
    "load_baseline",
    "run_checks",
    "write_baseline",
]
