"""kernel-parity: every CUDA kernel wrapper needs ops wiring, a plain twin
and a CUDA parity test.

The port's dispatch contract (``kernels/ops.py``): a CUDA tensor launches
the hand-written kernel or raises; a CPU tensor runs the plain PyTorch
version from ``kernels/ref.py``.  The CPU tests therefore never run a
kernel, so the only thing standing between a kernel edit and a silently
wrong answer on the card is a test that runs on the card and holds the
kernel against its plain version.

The kernels checked are the public functions of
``src/repro_torch/kernels/<kernel>.py`` (not ``ops.py``, ``ref.py`` or
``__init__.py``), plus every private name ``ops.py`` imports from such a
module (a private wrapper ``ops`` dispatches to, such as
``_rg_lru_pallas_bwd``).  Three rules per kernel:

  1. **wired** — some public ``ops.py`` function references it.  A
     module-level ``class X(torch.autograd.Function)`` is an alias: a
     function naming ``X`` inherits every name used in ``X``'s methods;
  2. **plain twin** — ``kernels/ref.py`` exists;
  3. **CUDA parity test** — some test function in ``tests/test_torch_*.py``
     carries the ``cuda`` marker (its module's ``pytestmark``, its class's
     or its own decorator), calls the kernel or one of its dispatchers as
     imported from the port, and references the port's ``ref``
     (``repro_torch.kernels.ref``) in the same function.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, Iterator, List, Set, Tuple

from ..core import (PACKAGE, TESTS, Finding, Module, Repo, attr_chain,
                    register_check)

_KERNELS = PACKAGE + "kernels/"
_EXCLUDE = ("ops.py", "ref.py", "__init__.py")
_PORT_KERNELS = "repro_torch.kernels"
_PORT_REF = _PORT_KERNELS + ".ref"


def _kernel_modules(repo: Repo) -> List[Module]:
    return [m for m in repo.under(_KERNELS)
            if "/" not in m.relpath[len(_KERNELS):]
            and not m.relpath.endswith(_EXCLUDE)]


def _stem(mod: Module) -> str:
    return mod.relpath[len(_KERNELS):-len(".py")]


def _ops_imports(ops: Module) -> Dict[str, Set[str]]:
    """kernel module stem -> names ``ops.py`` imports from it."""
    prefix = _PORT_KERNELS + "."
    out: Dict[str, Set[str]] = {}
    for node in (ops.tree.body if ops.tree is not None else []):
        if not isinstance(node, ast.ImportFrom) or not node.module:
            continue
        if node.level == 1:
            stem = node.module
        elif node.level == 0 and node.module.startswith(prefix):
            stem = node.module[len(prefix):]
        else:
            continue
        out.setdefault(stem, set()).update(a.name for a in node.names)
    return out


def kernels(repo: Repo) -> List[Tuple[Module, ast.FunctionDef]]:
    """Every kernel the check covers, as (module, def) pairs."""
    ops = repo.get("kernels/ops.py")
    imported = _ops_imports(ops) if ops is not None else {}
    out = []
    for mod in _kernel_modules(repo):
        if mod.tree is None:
            continue
        private_ok = imported.get(_stem(mod), set())
        out.extend((mod, n) for n in mod.tree.body
                   if isinstance(n, ast.FunctionDef)
                   and (not n.name.startswith("_") or n.name in private_ok))
    return out


def _names_used(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _is_autograd_function(cls: ast.ClassDef) -> bool:
    return any(attr_chain(b)[-2:] in (["autograd", "Function"], ["Function"])
               for b in cls.bases)


def _ops_reference_map(ops: Module) -> Dict[str, Set[str]]:
    """public ops function name -> every Name it references, with the
    names used in the ``torch.autograd.Function`` classes it names merged
    in (one hop)."""
    tree = ops.tree
    if tree is None:
        return {}
    classes = {node.name: _names_used(node) for node in tree.body
               if isinstance(node, ast.ClassDef)
               and _is_autograd_function(node)}
    out: Dict[str, Set[str]] = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) \
                and not node.name.startswith("_"):
            refs = _names_used(node)
            for cls in refs & set(classes):
                refs |= classes[cls]
            out[node.name] = refs
    return out


# ------------------------------------------------------------- test scanning
class _Bindings:
    """What a test module and one of its test functions bind to the
    port's kernels: the ``ref`` names, the module aliases (``ops``, a
    kernel module) and the directly imported functions (alias -> name)."""

    def __init__(self, kernel_stems: Set[str]) -> None:
        self.port_modules = {f"{_PORT_KERNELS}.{s}"
                             for s in kernel_stems | {"ops"}}
        self.refs: Set[str] = set()
        self.modules: Set[str] = set()
        self.funcs: Dict[str, str] = {}

    def add(self, nodes: Iterable[ast.AST]) -> "_Bindings":
        for node in nodes:
            if isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    name = a.asname or a.name
                    if node.module == _PORT_REF or (
                            node.module == _PORT_KERNELS and a.name == "ref"):
                        self.refs.add(name)
                    elif node.module == _PORT_KERNELS and \
                            f"{_PORT_KERNELS}.{a.name}" in self.port_modules:
                        self.modules.add(name)
                    elif node.module in self.port_modules:
                        self.funcs[name] = a.name
            elif isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname and a.name == _PORT_REF:
                        self.refs.add(a.asname)
                    elif a.asname and a.name in self.port_modules:
                        self.modules.add(a.asname)
        return self

    def calls(self, call: ast.Call, targets: Set[str]) -> bool:
        """True when ``call`` calls one of ``targets`` from the port."""
        fn = call.func
        if isinstance(fn, ast.Name):
            return self.funcs.get(fn.id) in targets
        chain = attr_chain(fn)
        return (len(chain) == 2 and chain[0] in self.modules
                and chain[1] in targets)


def _is_cuda_mark(expr: ast.AST) -> bool:
    if isinstance(expr, ast.Call):
        expr = expr.func
    return attr_chain(expr)[-2:] == ["mark", "cuda"]


def _pytestmark(body: List[ast.stmt]) -> bool:
    """A ``pytestmark = pytest.mark.cuda`` (or a list holding it)."""
    for node in body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "pytestmark"
                for t in node.targets):
            marks = (node.value.elts
                     if isinstance(node.value, (ast.List, ast.Tuple))
                     else [node.value])
            if any(_is_cuda_mark(m) for m in marks):
                return True
    return False


def _cuda_tests(tree: ast.Module) -> Iterator[ast.FunctionDef]:
    """Test functions (``test*``, top level or in a class) that carry the
    ``cuda`` marker."""

    def walk(body: List[ast.stmt], marked: bool) -> Iterator:
        marked = marked or _pytestmark(body)
        for node in body:
            if isinstance(node, ast.FunctionDef) \
                    and node.name.startswith("test") \
                    and (marked or any(map(_is_cuda_mark,
                                           node.decorator_list))):
                yield node
            elif isinstance(node, ast.ClassDef):
                yield from walk(node.body, marked or any(
                    map(_is_cuda_mark, node.decorator_list)))

    yield from walk(tree.body, False)


def _has_parity_test(repo: Repo, stems: Set[str], targets: Set[str]) -> bool:
    for mod in repo.under(TESTS):
        tree = mod.tree
        if tree is None:
            continue
        for func in _cuda_tests(tree):
            b = _Bindings(stems).add(tree.body).add(ast.walk(func))
            calls = any(isinstance(n, ast.Call) and b.calls(n, targets)
                        for n in ast.walk(func))
            if calls and any(isinstance(n, ast.Name) and n.id in b.refs
                             for n in ast.walk(func)):
                return True
    return False


@register_check(
    "kernel-parity",
    "every CUDA kernel wrapper is wired in ops.py, has a ref.py plain twin "
    "and a cuda-marked parity test in tests/test_torch_*.py")
def check(repo: Repo) -> List[Finding]:
    out: List[Finding] = []
    found = kernels(repo)
    if not found:
        return out
    ops = repo.get("kernels/ops.py")
    ref = repo.get("kernels/ref.py")
    ops_refs = _ops_reference_map(ops) if ops is not None else {}
    stems = {_stem(m) for m in _kernel_modules(repo)}
    for mod, fn in found:
        if ref is None:
            out.append(Finding(
                check="kernel-parity", path=mod.relpath, line=fn.lineno,
                obj=fn.name, key="no-ref-module",
                message="kernels/ref.py is missing — every CUDA kernel "
                        "needs the plain PyTorch twin its ops dispatch "
                        "runs on CPU tensors"))
            continue
        dispatchers = {name for name, refs in ops_refs.items()
                       if fn.name in refs}
        if not dispatchers:
            out.append(Finding(
                check="kernel-parity", path=mod.relpath, line=fn.lineno,
                obj=fn.name, key="unwired",
                message=f"kernel {fn.name!r} is not referenced by any "
                        "public ops.py function (directly or through a "
                        "torch.autograd.Function) — the CUDA/CPU dispatch "
                        "contract never covers it"))
            continue
        targets = dispatchers | {fn.name}
        if not _has_parity_test(repo, stems, targets):
            out.append(Finding(
                check="kernel-parity", path=mod.relpath, line=fn.lineno,
                obj=fn.name, key="no-parity-test",
                message=f"no CUDA parity test for kernel {fn.name!r}: no "
                        "cuda-marked test function in tests/test_torch_*.py "
                        f"calls {sorted(targets)} and compares against "
                        "repro_torch.kernels.ref"))
    return out
