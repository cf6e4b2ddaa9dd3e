"""metrolint core for the port: findings, repo loading, check registry,
baseline.

Checks are plain functions ``check(repo) -> List[Finding]`` registered via
:func:`register_check`.  A :class:`Repo` lazily parses the port's Python
files once and hands the same ASTs to all checks.

Scope is by *prefix*: a :class:`Repo` reads only ``src/repro_torch/**`` and
``tests/test_torch_*.py``, and :meth:`Repo.get` resolves a path relative to
``src/repro_torch/``.  The JAX package, its tests and any copy of the tree
unpacked elsewhere under the root (``build/``, say) are never read, so the
fixture tests can exercise the checks on miniature tmp-dir repos with the
port's layout, and a chip run's unpacked checkout adds no findings.

Baseline discipline: a finding's :attr:`Finding.fingerprint` deliberately
excludes the line number (moves must not invalidate suppressions) and
instead keys on ``(check, path, obj, key)`` where ``obj`` is the enclosing
scope's qualname and ``key`` a per-check stable discriminator.
"""
from __future__ import annotations

import ast
import dataclasses
import json
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

BASELINE_NAME = "metrolint_torch.baseline.json"
BASELINE_VERSION = 1

# the port's package, and its test files under tests/
PACKAGE = "src/repro_torch/"
TESTS = "tests/"
TEST_GLOB = "test_torch_*.py"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation at ``path:line``."""

    check: str
    path: str  # repo-relative posix path
    line: int
    obj: str  # qualname of the enclosing scope ('' = module level)
    key: str  # stable discriminator within (check, path, obj)
    message: str

    @property
    def fingerprint(self) -> str:
        """Line-independent identity used for baseline matching."""
        return f"{self.check}::{self.path}::{self.obj}::{self.key}"

    def render(self) -> str:
        where = f" [{self.obj}]" if self.obj else ""
        return f"{self.path}:{self.line}: {self.check}:{where} {self.message}"


class Module:
    """One parsed source file (AST parsed lazily, cached)."""

    def __init__(self, root: Path, path: Path) -> None:
        self.abspath = path
        self.relpath = path.relative_to(root).as_posix()
        self._source: Optional[str] = None
        self._tree: Optional[ast.Module] = None
        self._error: Optional[SyntaxError] = None

    @property
    def source(self) -> str:
        if self._source is None:
            self._source = self.abspath.read_text()
        return self._source

    @property
    def tree(self) -> Optional[ast.Module]:
        """Parsed AST, or None when the file does not parse (the syntax
        error is surfaced as its own finding by :func:`run_checks`)."""
        if self._tree is None and self._error is None:
            try:
                self._tree = ast.parse(self.source)
            except SyntaxError as e:  # pragma: no cover - defensive
                self._error = e
        return self._tree

    @property
    def syntax_error(self) -> Optional[SyntaxError]:
        self.tree
        return self._error


class Repo:
    """The port's Python files under one root, parsed once and shared by
    checks: ``src/repro_torch/**/*.py`` and ``tests/test_torch_*.py``."""

    def __init__(self, root: Path) -> None:
        self.root = Path(root).resolve()
        self._modules: Optional[List[Module]] = None

    def modules(self) -> List[Module]:
        if self._modules is None:
            paths = list((self.root / PACKAGE).rglob("*.py"))
            paths += (self.root / TESTS).glob(TEST_GLOB)
            self._modules = [Module(self.root, p) for p in sorted(paths)
                             if "__pycache__" not in p.parts]
        return self._modules

    def under(self, prefix: str) -> List[Module]:
        """Modules whose repo-relative path starts with ``prefix``."""
        return [m for m in self.modules() if m.relpath.startswith(prefix)]

    def get(self, rel: str) -> Optional[Module]:
        """The module at ``src/repro_torch/<rel>``, or None."""
        path = PACKAGE + rel
        for m in self.modules():
            if m.relpath == path:
                return m
        return None

    def package(self, *rels: str) -> List[Module]:
        """The modules present among ``src/repro_torch/<rel>``."""
        return [m for m in (self.get(r) for r in rels) if m is not None]


# --------------------------------------------------------------- AST helpers
def iter_scopes(tree: ast.Module) -> Iterator[Tuple[str, ast.AST]]:
    """Yield ``(qualname, node)`` for every function/method, walking into
    classes (``Cls.meth``) but not into nested functions (a nested def is
    analyzed as part of its enclosing scope)."""

    def walk(body: Sequence[ast.stmt], prefix: str) -> Iterator:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield prefix + node.name, node
            elif isinstance(node, ast.ClassDef):
                yield from walk(node.body, prefix + node.name + ".")

    yield from walk(tree.body, "")


def attr_chain(node: ast.AST) -> List[str]:
    """``a.b.c`` -> ``['a', 'b', 'c']``; empty when the base is dynamic."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return []


def find_scope(tree: ast.Module, qualname: str) -> Optional[ast.AST]:
    for name, node in iter_scopes(tree):
        if name == qualname:
            return node
    return None


# ------------------------------------------------------------ check registry
CheckFn = Callable[[Repo], List[Finding]]
_CHECKS: Dict[str, CheckFn] = {}
_CHECK_DOCS: Dict[str, str] = {}


def register_check(check_id: str, doc: str) -> Callable[[CheckFn], CheckFn]:
    def deco(fn: CheckFn) -> CheckFn:
        if check_id in _CHECKS:
            raise ValueError(f"duplicate check id {check_id!r}")
        _CHECKS[check_id] = fn
        _CHECK_DOCS[check_id] = doc
        return fn

    return deco


def all_checks() -> Dict[str, str]:
    """check id -> one-line description, in registration order."""
    return dict(_CHECK_DOCS)


def run_checks(root: Path,
               checks: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the selected (default: all) checks over the repo at ``root``."""
    repo = Repo(Path(root))
    selected = list(checks) if checks else list(_CHECKS)
    unknown = [c for c in selected if c not in _CHECKS]
    if unknown:
        raise ValueError(f"unknown checks {unknown}; have {sorted(_CHECKS)}")
    findings: List[Finding] = []
    for m in repo.modules():
        err = m.syntax_error
        if err is not None:
            findings.append(Finding(
                check="parse", path=m.relpath, line=err.lineno or 1,
                obj="", key="syntax-error", message=f"does not parse: {err}"))
    for cid in selected:
        findings.extend(_CHECKS[cid](repo))
    findings.sort(key=lambda f: (f.path, f.line, f.check, f.key))
    return findings


# ------------------------------------------------------------------ baseline
@dataclasses.dataclass(frozen=True)
class Suppression:
    check: str
    path: str
    obj: str
    key: str
    reason: str

    @property
    def fingerprint(self) -> str:
        return f"{self.check}::{self.path}::{self.obj}::{self.key}"


def load_baseline(path: Path) -> List[Suppression]:
    """Parse the committed baseline; every entry must carry a reason."""
    if not Path(path).exists():
        return []
    doc = json.loads(Path(path).read_text())
    if doc.get("version") != BASELINE_VERSION:
        raise ValueError(f"baseline {path}: unsupported version "
                         f"{doc.get('version')!r}")
    out = []
    for i, e in enumerate(doc.get("suppressions", [])):
        reason = str(e.get("reason", "")).strip()
        if not reason:
            raise ValueError(f"baseline {path}: suppression #{i} has no "
                             "reason — every deliberate deviation must say "
                             "why it is deliberate")
        out.append(Suppression(check=e["check"], path=e["path"],
                               obj=e.get("obj", ""), key=e.get("key", ""),
                               reason=reason))
    return out


def apply_baseline(findings: Sequence[Finding],
                   baseline: Sequence[Suppression]
                   ) -> Tuple[List[Finding], List[Finding],
                              List[Suppression]]:
    """Split into (new, suppressed, stale-suppressions).

    Stale entries — suppressions matching no current finding — are
    reported (and fail the CLI) so the baseline shrinks as findings are
    actually fixed instead of fossilizing."""
    by_fp = {s.fingerprint: s for s in baseline}
    new, suppressed = [], []
    hit = set()
    for f in findings:
        if f.fingerprint in by_fp:
            suppressed.append(f)
            hit.add(f.fingerprint)
        else:
            new.append(f)
    stale = [s for s in baseline if s.fingerprint not in hit]
    return new, suppressed, stale


def write_baseline(path: Path, findings: Sequence[Finding],
                   existing: Sequence[Suppression] = (),
                   default_reason: str = "baselined at adoption; triage"
                   ) -> None:
    """Write a baseline covering ``findings``, preserving the reasons of
    entries already present."""
    reasons = {s.fingerprint: s.reason for s in existing}
    entries = []
    for f in findings:
        entries.append({
            "check": f.check, "path": f.path, "obj": f.obj, "key": f.key,
            "reason": reasons.get(f.fingerprint, default_reason),
        })
    doc = {"version": BASELINE_VERSION, "suppressions": entries}
    Path(path).write_text(json.dumps(doc, indent=1) + "\n")
