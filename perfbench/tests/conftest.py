"""Shared set-up of the benchmark's own tests (not collected by the
repository's test run, whose ``testpaths`` is ``tests/``):

    PYTHONPATH=src python -m pytest -q perfbench/tests
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

torch.set_num_threads(2)

# the dense family at the program's smoke widths (its registry's
# internlm2_20b.smoke_config), on 2 sequences of 64 tokens a micro-batch
TINY_MODEL = dict(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                  vocab=512)
TINY_TRAFFIC = dict(seq=64, seqs_per_step=4, n_micro=2)
# the global-norm clip engages in the cells (a first gradient norm of 12.2
# and 17.3 against 1.0); at the tiny sizes the norm reads 0.76-0.78, so
# the clip is lowered to 0.1 there, to engage as it does in the cells
TINY_OPTIMIZER = dict(grad_clip=0.1)
# the limits at those sizes, set as the cells' are (PERF.md, section 2):
# over 14 seeds on the CPU the program read at most gnorm1 1.4e-4, grad1
# 9.7e-4 and change 1.7e-3 (both configurations); the float8 control
# read grad1 3.2e-3 and more, the half-batch fault gnorm1 0.41 and change
# 0.20 and more, the doubled leaf change 0.998, the missing clip grad1 6.7
TINY_LIMITS = {"gnorm1": 0.015, "grad1": 0.0023, "change": 0.03}


def tiny(cell: dict, **model) -> dict:
    """``cell`` at the tiny sizes, with the tiny sizes' limits."""
    out = dict(cell)
    out["model"] = {**cell["model"], **TINY_MODEL, **model}
    out["traffic"] = {**cell["traffic"], **TINY_TRAFFIC,
                      "optimizer": {**cell["traffic"]["optimizer"],
                                    **TINY_OPTIMIZER}}
    out["limits"] = dict(TINY_LIMITS)
    return out


@pytest.fixture
def cpu():
    return torch.device("cpu")
