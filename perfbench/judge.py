"""The comparison that decides ``correct`` for a training cell.

Both sides give the same readings (``reference.readings`` and the
program's, taken by ``train_cell`` from its own state): each checked
step's loss, the first step's global gradient norm before the clip, each
leaf's norm of the first gradient as the optimizer applies it, and each
leaf's norm of its parameters' change after the checked steps.  The
numbers compared, each against a limit of its own from the cell's file:

- ``gnorm1``: the gap between the global gradient norms, as a share of
  the reference's;
- ``grad1`` and ``change``: the worst leaf's gap between the two norms,
  as a share of the reference's norm of that leaf or of the median
  leaf's, whichever is larger.

The losses are not compared: at the cells' sizes the gap between the two
sides' losses reads as much for the program as for its float8 control,
so no limit separates them (their readings are logged).

A leaf whose reference gradient is under a thousandth of the median
leaf's is left out of ``grad1`` and ``change``: it is nought to rounding,
and Adam moves it by round-off alone.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

NOUGHT = 1e-3  # a leaf's gradient under this share of the median's


def _worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                    leaves: List[str]) -> float:
    floor = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], floor) for k in leaves)


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers compared, by name."""
    out = {"gnorm1": abs(prog["grad_norm"] - ref["grad_norm"])
           / ref["grad_norm"]}
    grads = ref["leaf_grad_norms"]
    median = statistics.median(grads.values())
    counted = [k for k, g in grads.items() if g >= NOUGHT * median]
    out["grad1"] = _worst_leaf_gap(prog["leaf_grad_norms"], grads, counted)
    out["change"] = _worst_leaf_gap(prog["leaf_change_norms"],
                                    ref["leaf_change_norms"], counted)
    return out


def verdict(prog: dict, ref: dict, limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {name: {"value", "limit"}}): correct when every number is
    finite and within its limit, and the program gave every number that
    has a limit."""
    got = numbers(prog, ref)
    table = {k: {"value": got.get(k, float("nan")), "limit": lim}
             for k, lim in limits.items()}
    ok = all(row["value"] <= row["limit"] for row in table.values())
    return ok, table
