"""shared-state race: module-level mutable containers mutated without a lock.

``experiment.sweep(workers=N, mode="thread")`` runs simulations on a
thread pool, so any module-level list/dict/set that worker-path code
mutates is a data race.  CPython's GIL makes single ``append``s atomic,
but read-modify-write patterns (``if k not in cache: cache[k] = ...``,
``list.extend`` of interleaved rows, clear-then-refill) interleave and
corrupt.

Rule: in the modules a ``sweep(mode="thread")`` worker reaches in the port
(``src/repro_torch/core/``, ``src/repro_torch/kernels/`` — the fluid
engine's and the planner's ``'kernel'`` backends call the kernel wrappers,
which cache per-device limits — and ``src/repro_torch/_cuda_build.py``),
every function-scope mutation of a module-level mutable container must
sit inside a ``with <lock>:`` block, where the lock is a module-level
``threading.Lock()``/``RLock()`` (or any context-manager variable whose
name contains "lock").  Deliberately unlocked state is suppressed in the
baseline *with the reason stated*.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from ..core import (PACKAGE, Finding, Repo, attr_chain, iter_scopes,
                    register_check)

_MUTATORS = {"append", "add", "update", "setdefault", "extend", "insert",
             "pop", "popitem", "clear", "remove", "discard"}
_CONTAINER_CALLS = {"list", "dict", "set", "defaultdict", "OrderedDict",
                    "deque", "Counter"}


_SCOPE_DIRS = (PACKAGE + "core/", PACKAGE + "kernels/")
_SCOPE_FILES = (PACKAGE + "_cuda_build.py",)


def _in_scope(relpath: str) -> bool:
    return relpath.startswith(_SCOPE_DIRS) or relpath in _SCOPE_FILES


def _module_state(tree: ast.Module) -> Tuple[Dict[str, int], Set[str]]:
    """(mutable module-level containers -> def line, lock names)."""
    mutables: Dict[str, int] = {}
    locks: Set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name, val = node.targets[0].id, node.value
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name) \
                and node.value is not None:
            name, val = node.target.id, node.value
        else:
            continue
        if isinstance(val, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                            ast.DictComp, ast.SetComp)):
            mutables[name] = node.lineno
        elif isinstance(val, ast.Call):
            chain = attr_chain(val.func)
            leaf = chain[-1] if chain else ""
            if leaf in _CONTAINER_CALLS:
                mutables[name] = node.lineno
            elif leaf in ("Lock", "RLock"):
                locks.add(name)
    return mutables, locks


def _is_lock_name(expr: ast.AST, locks: Set[str]) -> bool:
    chain = attr_chain(expr)
    if not chain:
        return False
    leaf = chain[-1]
    return leaf in locks or "lock" in leaf.lower()


def _locked_node_ids(func: ast.AST, locks: Set[str]) -> Set[int]:
    """ids of AST nodes lexically inside a ``with <lock>:`` body."""
    out: Set[int] = set()
    for node in ast.walk(func):
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                _is_lock_name(item.context_expr, locks)
                for item in node.items):
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    out.add(id(sub))
    return out


def _mutations(func: ast.AST, mutables: Dict[str, int]):
    """Yield ``(node, global_name, what)`` for each mutation of a tracked
    module-level container."""
    declared_global: Set[str] = set()
    for node in ast.walk(func):
        if isinstance(node, ast.Global):
            declared_global.update(node.names)
    for node in ast.walk(func):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id in mutables \
                and node.func.attr in _MUTATORS:
            yield node, node.func.value.id, f".{node.func.attr}()"
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, ast.AugAssign):
            targets = [node.target]
        for t in targets:
            for el in (t.elts if isinstance(t, ast.Tuple) else [t]):
                if isinstance(el, ast.Subscript) \
                        and isinstance(el.value, ast.Name) \
                        and el.value.id in mutables:
                    yield el, el.value.id, "[...] assignment"
                elif isinstance(el, ast.Name) and el.id in mutables \
                        and el.id in declared_global:
                    yield el, el.id, "rebinding (global)"


@register_check(
    "shared-state-race",
    "module-level mutable containers in thread-reachable code must be "
    "mutated under a lock")
def check(repo: Repo) -> List[Finding]:
    out: List[Finding] = []
    for mod in repo.modules():
        if not _in_scope(mod.relpath):
            continue
        tree = mod.tree
        if tree is None:
            continue
        mutables, locks = _module_state(tree)
        if not mutables:
            continue
        for qualname, func in iter_scopes(tree):
            locked = _locked_node_ids(func, locks)
            unlocked: Dict[str, List[Tuple[int, str]]] = {}
            for node, gname, what in _mutations(func, mutables):
                if id(node) not in locked:
                    unlocked.setdefault(gname, []).append(
                        (node.lineno, what))
            for gname, sites in sorted(unlocked.items()):
                line, what = sites[0]
                extra = (f" (+{len(sites) - 1} more)"
                         if len(sites) > 1 else "")
                out.append(Finding(
                    check="shared-state-race", path=mod.relpath, line=line,
                    obj=qualname, key=f"unlocked:{gname}",
                    message=f"mutates module-level {gname!r} via {what}"
                            f"{extra} outside any lock — thread sweeps "
                            "(sweep(mode='thread')) interleave here"))
    return out
