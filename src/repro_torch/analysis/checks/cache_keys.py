"""cache-key completeness: content-addressed caches must key on ALL inputs.

Two cache families carry correctness weight here:

  * ``benchmarks/cache.py::fingerprint`` — the nightly sweep cache.  A
    result-relevant input that is missing from the fingerprint silently
    serves stale sweep results.  The rule is *field coverage*: for each
    parameter bound to a known dataclass, every dataclass field must be
    covered by the fingerprint — either accessed directly (``.mode``),
    through a declared alias (``materialize()`` consumes ``build``), or by
    handing the whole object to a canonicalizing helper (one that walks
    ``dataclasses.fields``/``asdict``).  Property accesses are deliberately
    NOT coverage: a derived human label (``p.name``) can collide across
    distinct configurations, which is exactly the bug class this catches.

  * ``rotation.PlanCache`` memo keys — ``solve_link`` / ``solve_link_batch``
    / ``_build_joint_problem`` build ``key = (...)`` tuples that must
    mention every solver knob in the signature (``mode``, ``demand``,
    ``rotation_mode``, ``di_pre``, ``g_t_ms``, ``e_t_frac``, and for the
    joint path ``backend`` / ``max_exhaustive``).  A knob missing from the
    key makes two different solves share one memo slot.

Spec paths resolve under ``src/repro_torch/``.  Specs skip silently when
their target *file* is absent (fixture mini-repos only materialize what
they test, and the port has no sweep cache yet, so the fingerprint spec is
skipped on the real tree) but report drift when the file exists and the
expected function has disappeared — a rename must not silently disable
the check.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from ..core import Finding, Module, Repo, find_scope, register_check


# --------------------------------------------------- fingerprint field specs
class Binding:
    """One fingerprint parameter bound to a dataclass whose fields must
    all be covered."""

    def __init__(self, param: str, dc_suffix: str, dc_name: str,
                 aliases: Optional[Dict[str, Set[str]]] = None,
                 ignore: Optional[Dict[str, str]] = None) -> None:
        self.param = param
        self.dc_suffix = dc_suffix  # path of the defining module
        self.dc_name = dc_name
        self.aliases = aliases or {}  # accessed attr -> fields it covers
        self.ignore = ignore or {}  # field -> why it is excluded by design


FINGERPRINT_SPECS = [
    ("benchmarks/cache.py", "fingerprint", [
        Binding("scenario", "core/experiment.py", "Scenario",
                aliases={"materialize": {"build"}},
                ignore={"name": "human-readable label; content is hashed "
                                "via materialize()"}),
        Binding("policies", "core/experiment.py", "Policy"),
        Binding("cfg", "core/simulator.py", "SimConfig"),
        # SimConfig.telemetry nests the observation-channel dataclass;
        # its distortion knobs are result-relevant and must be hashed by
        # content too (a dataclasses-walking canonicalizer recurses)
        Binding("cfg", "core/telemetry.py", "TelemetryChannel"),
    ]),
]

# ------------------------------------------------------ PlanCache knob specs
_SOLVER_KNOBS = {"mode", "demand", "rotation_mode", "di_pre", "g_t_ms",
                 "e_t_frac"}
# link capacity is a mutable input since fault injection (LinkFailure
# zeroes it mid-run, recovery restores it): a memo key omitting it would
# serve a pre-failure scheme on the post-failure link
KNOB_SPECS = [
    ("core/rotation.py", "solve_link", _SOLVER_KNOBS | {"cap"}),
    ("core/rotation.py", "solve_link_batch", _SOLVER_KNOBS | {"cap"}),
    ("core/rotation.py", "_build_joint_problem",
     _SOLVER_KNOBS | {"backend", "max_exhaustive", "caps", "bw_lp"}),
]


def _dataclass_fields(mod: Module, cls: str) -> Optional[Set[str]]:
    tree = mod.tree
    if tree is None:
        return None
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == cls:
            out = set()
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) \
                        and isinstance(stmt.target, ast.Name):
                    ann = ast.dump(stmt.annotation)
                    if "ClassVar" not in ann:
                        out.add(stmt.target.id)
            return out
    return None


def _covering_helpers(mod: Module) -> Set[str]:
    """Module-level functions that canonicalize whole dataclasses (walk
    ``dataclasses.fields``/``asdict``), plus one hop of helpers that call
    them (``_cluster_canon`` -> ``_canon``)."""
    tree = mod.tree
    if tree is None:
        return set()
    direct: Set[str] = set()
    calls: Dict[str, Set[str]] = {}
    for node in tree.body:
        if not isinstance(node, ast.FunctionDef):
            continue
        names = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Attribute):
                names.add(sub.attr)
            elif isinstance(sub, ast.Name):
                names.add(sub.id)
        if names & {"fields", "asdict"}:
            direct.add(node.name)
        calls[node.name] = names
    # fixpoint over call-through (helpers delegating to covering helpers)
    changed = True
    while changed:
        changed = False
        for fn, names in calls.items():
            if fn not in direct and names & direct:
                direct.add(fn)
                changed = True
    return direct


def _tracked_names(func: ast.AST, param: str) -> Set[str]:
    """``param`` plus loop/comprehension variables iterating over it."""
    tracked = {param}
    changed = True

    def unwrap(it: ast.AST) -> Optional[str]:
        while isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                and it.func.id in ("sorted", "list", "tuple", "enumerate",
                                   "reversed") and it.args:
            it = it.args[0]
        return it.id if isinstance(it, ast.Name) else None

    def targets_of(t: ast.AST) -> List[str]:
        if isinstance(t, ast.Name):
            return [t.id]
        if isinstance(t, ast.Tuple):
            return [e.id for e in t.elts if isinstance(e, ast.Name)]
        return []

    while changed:
        changed = False
        for node in ast.walk(func):
            pairs = []
            if isinstance(node, (ast.For, ast.AsyncFor)):
                pairs.append((node.iter, node.target))
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                pairs.extend((g.iter, g.target) for g in node.generators)
            for it, tgt in pairs:
                src = unwrap(it)
                if src in tracked:
                    for name in targets_of(tgt):
                        if name not in tracked:
                            tracked.add(name)
                            changed = True
    return tracked


def _coverage(func: ast.AST, binding: Binding, fields: Set[str],
              helpers: Set[str]) -> Set[str]:
    tracked = _tracked_names(func, binding.param)
    covered: Set[str] = set()
    for node in ast.walk(func):
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id in tracked:
            if node.attr in fields:
                covered.add(node.attr)
            covered.update(binding.aliases.get(node.attr, ()))
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in helpers:
            if any(isinstance(a, ast.Name) and a.id in tracked
                   for a in node.args):
                return set(fields)
    return covered


@register_check(
    "cache-key-completeness",
    "content caches (bench fingerprint, PlanCache memo keys) must cover "
    "every result-relevant input")
def check(repo: Repo) -> List[Finding]:
    out: List[Finding] = []

    for suffix, qualname, bindings in FINGERPRINT_SPECS:
        mod = repo.get(suffix)
        if mod is None or mod.tree is None:
            continue
        func = find_scope(mod.tree, qualname)
        if func is None:
            out.append(Finding(
                check="cache-key-completeness", path=mod.relpath, line=1,
                obj=qualname, key="spec-drift",
                message=f"expected fingerprint function {qualname!r} not "
                        "found — update the cache-key spec alongside the "
                        "rename"))
            continue
        helpers = _covering_helpers(mod)
        for b in bindings:
            dc_mod = repo.get(b.dc_suffix)
            if dc_mod is None:
                continue
            fields = _dataclass_fields(dc_mod, b.dc_name)
            if fields is None:
                out.append(Finding(
                    check="cache-key-completeness", path=mod.relpath,
                    line=func.lineno, obj=qualname,
                    key=f"spec-drift:{b.dc_name}",
                    message=f"dataclass {b.dc_name!r} not found in "
                            f"{b.dc_suffix} — update the cache-key spec"))
                continue
            covered = _coverage(func, b, fields, helpers)
            missing = sorted(fields - covered - set(b.ignore))
            if missing:
                out.append(Finding(
                    check="cache-key-completeness", path=mod.relpath,
                    line=func.lineno, obj=qualname,
                    key=f"uncovered:{b.param}",
                    message=f"{b.dc_name} fields {missing} of parameter "
                            f"{b.param!r} never reach the fingerprint — "
                            "hash content (e.g. via a dataclasses.fields "
                            "canonicalizer), not derived labels"))

    for suffix, qualname, required in KNOB_SPECS:
        mod = repo.get(suffix)
        if mod is None or mod.tree is None:
            continue
        func = find_scope(mod.tree, qualname)
        if func is None:
            out.append(Finding(
                check="cache-key-completeness", path=mod.relpath, line=1,
                obj=qualname, key="spec-drift",
                message=f"expected solver {qualname!r} not found — update "
                        "the cache-key spec alongside the rename"))
            continue
        key_names: Set[str] = set()
        key_line = 0
        for node in ast.walk(func):
            if isinstance(node, ast.Assign) \
                    and any(isinstance(t, ast.Name) and t.id == "key"
                            for t in node.targets) \
                    and isinstance(node.value, ast.Tuple):
                key_line = key_line or node.lineno
                key_names.update(n.id for n in ast.walk(node.value)
                                 if isinstance(n, ast.Name))
        if not key_names:
            out.append(Finding(
                check="cache-key-completeness", path=mod.relpath,
                line=func.lineno, obj=qualname, key="no-key",
                message="no `key = (...)` memo-key tuple found — the "
                        "PlanCache contract requires a content key"))
            continue
        missing = sorted(required - key_names)
        if missing:
            out.append(Finding(
                check="cache-key-completeness", path=mod.relpath,
                line=key_line, obj=qualname, key="knobs",
                message=f"memo key omits solver knobs {missing} — two "
                        "solves differing only in them would share a "
                        "PlanCache slot"))
    return out
