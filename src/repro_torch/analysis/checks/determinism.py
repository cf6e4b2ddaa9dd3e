"""determinism: no nondeterminism hazards in the bit-for-bit-pinned modules.

The seed goldens (S1-S5/F2/F4/J1/D1/D2) and the backend-parity suites pin
``scoring.py``, ``rotation.py``, ``fluid.py`` and ``simulator.py``
bit-for-bit on the python oracle paths.  Three hazard classes break that
silently:

  * **set-order iteration** — iterating a set (or anything derived from
    one without ``sorted()``) makes result order depend on hash seeding;
  * **unseeded randomness** — module-level ``np.random.*`` / ``random.*``
    draws bypass the simulator's seeded ``default_rng``, and so do draws
    from torch's global generator (``torch.rand``, ``randn``, ``randint``,
    ``randperm``, ``normal``, ``bernoulli``, ``multinomial`` without
    ``generator=``);
  * **float32 literals** — the pinned oracle paths are float64; a float32
    cast inside them (``np.float32``, ``torch.float32``, ``"float32"``)
    truncates the goldens.  A function that is float32 by design is
    suppressed in the baseline with that reason.

The scope is the port's copies of those modules, ``src/repro_torch/core/``.
"""
from __future__ import annotations

import ast
from typing import Dict, List

from ..core import Finding, Repo, attr_chain, iter_scopes, register_check

SCOPE = ("core/scoring.py", "core/rotation.py", "core/fluid.py",
         "core/simulator.py")

# np.random attributes that are fine (seeded constructors / types)
SEEDED_OK = {"default_rng", "RandomState", "SeedSequence", "Generator",
             "PRNGKey", "seed"}
F32_NAMES = {"float32"}
# torch functions that draw from the global generator unless given one
TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal",
               "bernoulli", "multinomial"}
_WRAPPERS = {"list", "tuple", "enumerate", "reversed", "iter"}


def _set_locals(func: ast.AST) -> Dict[str, int]:
    """Local names assigned a set-valued expression exactly once."""
    counts: Dict[str, int] = {}
    setlike: Dict[str, int] = {}
    for node in ast.walk(func):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            counts[name] = counts.get(name, 0) + 1
            if _is_set_expr(node.value):
                setlike[name] = node.value.lineno
    return {n: ln for n, ln in setlike.items() if counts.get(n) == 1}


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("set", "frozenset")
    if isinstance(node, ast.BinOp) \
            and isinstance(node.op, (ast.BitAnd, ast.BitOr, ast.Sub,
                                     ast.BitXor)):
        return _is_set_expr(node.left) or _is_set_expr(node.right)
    return False


def _iter_hazard(it: ast.AST, sets: Dict[str, int]) -> bool:
    """True when the iterable of a for/comprehension is set-ordered."""
    if isinstance(it, ast.Call) and isinstance(it.func, ast.Name):
        if it.func.id == "sorted":
            return False
        if it.func.id in _WRAPPERS and it.args:
            return _iter_hazard(it.args[0], sets)
    if _is_set_expr(it):
        return True
    return isinstance(it, ast.Name) and it.id in sets


def _torch_global_draw(node: ast.AST) -> bool:
    """``torch.<draw>(...)`` called without a ``generator=`` keyword."""
    if not isinstance(node, ast.Call):
        return False
    chain = attr_chain(node.func)
    return (len(chain) == 2 and chain[0] == "torch"
            and chain[1] in TORCH_DRAWS
            and not any(kw.arg == "generator" for kw in node.keywords))


def _iterables(func: ast.AST):
    for node in ast.walk(func):
        if isinstance(node, (ast.For, ast.AsyncFor)):
            yield node.iter
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                yield gen.iter


@register_check(
    "determinism",
    "no set-order iteration / unseeded randomness / float32 literals in "
    "the bit-for-bit-pinned modules")
def check(repo: Repo) -> List[Finding]:
    out: List[Finding] = []
    for mod in repo.package(*SCOPE):
        tree = mod.tree
        if tree is None:
            continue
        for qualname, func in iter_scopes(tree):
            sets = _set_locals(func)
            n_set = 0
            for it in _iterables(func):
                if _iter_hazard(it, sets):
                    n_set += 1
                    out.append(Finding(
                        check="determinism", path=mod.relpath,
                        line=it.lineno, obj=qualname,
                        key=f"set-iteration:{n_set}",
                        message="iterates in set order — wrap in sorted() "
                                "or use an insertion-ordered container "
                                "(goldens pin this module bit-for-bit)"))
            n_rand = 0
            f32_line = 0
            for node in ast.walk(func):
                if isinstance(node, ast.Attribute):
                    chain_ok = (isinstance(node.value, ast.Attribute)
                                and node.value.attr == "random") or \
                               (isinstance(node.value, ast.Name)
                                and node.value.id == "random")
                    if chain_ok and node.attr not in SEEDED_OK:
                        n_rand += 1
                        out.append(Finding(
                            check="determinism", path=mod.relpath,
                            line=node.lineno, obj=qualname,
                            key=f"unseeded-random:{n_rand}",
                            message=f"np.random.{node.attr}/random."
                                    f"{node.attr} draws from global "
                                    "unseeded state — thread the seeded "
                                    "rng through instead"))
                    if node.attr in F32_NAMES and not f32_line:
                        f32_line = node.lineno
                if _torch_global_draw(node):
                    n_rand += 1
                    out.append(Finding(
                        check="determinism", path=mod.relpath,
                        line=node.lineno, obj=qualname,
                        key=f"unseeded-random:{n_rand}",
                        message=f"torch.{node.func.attr} draws from "
                                "torch's global generator — pass a seeded "
                                "generator= instead"))
                if isinstance(node, ast.Constant) \
                        and node.value == "float32" and not f32_line:
                    f32_line = node.lineno
            if f32_line:
                out.append(Finding(
                    check="determinism", path=mod.relpath, line=f32_line,
                    obj=qualname, key="float32",
                    message="float32 literal in a module the goldens pin "
                            "bit-for-bit (float64) — keep the oracle path "
                            "float64 or baseline the vectorized-backend "
                            "function with a reason"))
    return out
