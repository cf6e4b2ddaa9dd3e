"""epoch-soundness: demand/capacity mutations must bump a mutation epoch.

The planner memo (``rotation.PlanCache``) and the fluid engine's
per-component refill memo are only sound because EVERY mutation of
scheduler-visible link state advances ``Cluster.epoch`` or
``TaskRegistry.epoch`` (DESIGN.md section 15).  A mutation path that
forgets the bump silently serves stale plans.

Rule: in the port's epoch-bearing core modules
(``src/repro_torch/core/``), any function that mutates a
tracked demand/capacity attribute, calls the ``allocate``/``release``
primitives, or mutates a registry store (``registry.tasks`` /
``.jobs`` / ``.workloads``) must ALSO contain a reachable epoch advance
(``bump_epoch()`` / ``bump()`` / ``<x>.epoch += 1``) in the same function
scope.  Constructors, ``copy()`` factories, the bump definitions
themselves, and the ``Node.allocate``/``Node.release`` primitives (whose
CALLERS own the bump) are exempt.
"""
from __future__ import annotations

import ast
from typing import List

from ..core import Finding, Repo, attr_chain, iter_scopes, register_check

# the modules that own epoch-tagged state (under src/repro_torch/)
SCOPE = ("core/framework.py", "core/simulator.py", "core/controller.py",
         "core/events.py", "core/cluster.py")

# attributes whose assignment changes what schedulers/planners see
TRACKED_ATTRS = {"allocatable_gbps", "capacity_gbps", "bw_gbps", "traffic",
                 "allocated", "background", "latency"}
# method calls that mutate demand state on whatever object they hit
MUTATING_CALLS = {"allocate", "release"}
# registry stores: mutation of registry.<store> must bump
REGISTRY_STORES = {"tasks", "jobs", "workloads"}
STORE_MUTATORS = {"pop", "clear", "update", "setdefault", "popitem"}

BUMP_CALLS = {"bump_epoch", "bump"}
# functions that may mutate without bumping
EXEMPT_NAMES = {"__init__", "__post_init__", "copy"}
EXEMPT_QUALNAMES = {"Node.allocate", "Node.release"}


def _is_registry_store(node: ast.AST) -> bool:
    """True for attribute chains like ``self.registry.tasks`` /
    ``registry.jobs`` — a store access rooted at a registry object."""
    chain = attr_chain(node)
    return (len(chain) >= 2 and chain[-1] in REGISTRY_STORES
            and "registry" in chain[:-1])


def _mutations(func: ast.AST):
    """Yield ``(line, description)`` for every tracked mutation."""
    for node in ast.walk(func):
        targets = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            for el in (t.elts if isinstance(t, ast.Tuple) else [t]):
                sub = el
                if isinstance(sub, ast.Subscript):
                    sub = sub.value
                if isinstance(sub, ast.Attribute):
                    if sub.attr in TRACKED_ATTRS:
                        yield el.lineno, f"writes .{sub.attr}"
                    elif isinstance(el, ast.Subscript) \
                            and _is_registry_store(sub):
                        yield el.lineno, f"writes registry.{sub.attr}[...]"
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Name) and fn.id == "setattr" \
                    and len(node.args) >= 2 \
                    and isinstance(node.args[1], ast.Constant) \
                    and node.args[1].value in TRACKED_ATTRS:
                yield node.lineno, f"calls setattr(.., {node.args[1].value!r})"
            elif isinstance(fn, ast.Attribute):
                if fn.attr in MUTATING_CALLS:
                    yield node.lineno, f"calls .{fn.attr}()"
                elif (fn.attr in STORE_MUTATORS
                      and _is_registry_store(fn.value)):
                    chain = attr_chain(fn.value)
                    yield node.lineno, (f"calls {'.'.join(chain)}"
                                        f".{fn.attr}()")


def _has_bump(func: ast.AST) -> bool:
    for node in ast.walk(func):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in BUMP_CALLS:
            return True
        if isinstance(node, ast.AugAssign) \
                and isinstance(node.target, ast.Attribute) \
                and node.target.attr == "epoch":
            return True
    return False


@register_check(
    "epoch-soundness",
    "demand/capacity mutations must advance Cluster/TaskRegistry epochs")
def check(repo: Repo) -> List[Finding]:
    out: List[Finding] = []
    for mod in repo.package(*SCOPE):
        tree = mod.tree
        if tree is None:
            continue
        for qualname, func in iter_scopes(tree):
            short = qualname.rsplit(".", 1)[-1]
            if short in EXEMPT_NAMES or short in BUMP_CALLS \
                    or qualname in EXEMPT_QUALNAMES:
                continue
            muts = list(_mutations(func))
            if not muts or _has_bump(func):
                continue
            line, what = muts[0]
            extra = f" (+{len(muts) - 1} more)" if len(muts) > 1 else ""
            out.append(Finding(
                check="epoch-soundness", path=mod.relpath, line=line,
                obj=qualname, key="no-bump",
                message=f"{what}{extra} without a reachable bump_epoch()/"
                        "bump()/epoch increment in the same mutation scope "
                        "— epoch-scoped planner caches would serve stale "
                        "plans"))
    return out
