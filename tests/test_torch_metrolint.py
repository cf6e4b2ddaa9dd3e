"""The port's metrolint (``repro_torch.analysis``).

* Live parity: each fixture snippet of ``tests/test_metrolint.py`` for the
  epoch, determinism, cache-key and shared-state checks is written under
  ``src/repro/`` in one tmp repo and under ``src/repro_torch/`` in another;
  each package's ``run_checks`` runs on its own repo, and the findings must
  agree in check, line, obj, key and message.
* The port's own rules: the CUDA/CPU kernel dispatch contract
  (``autograd.Function`` wiring, private wrappers ``ops`` imports,
  ``cuda``-marked parity tests against the port's ``ref``), draws from
  torch's global generator, and kernel-wrapper caches.
* Prefix scoping, the real tree (copied to tmp), the committed
  ``metrolint_torch.baseline.json``, the CLI, and import isolation from the
  JAX package.
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import run_checks as ref_run_checks
from repro_torch.analysis import (all_checks, apply_baseline, load_baseline,
                                  run_checks)
from repro_torch.analysis.checks import kernel_parity
from repro_torch.analysis.cli import main
from repro_torch.analysis.core import BASELINE_NAME, Repo

REPO_ROOT = Path(__file__).resolve().parents[1]

# the port's counterpart of a reference fixture path: src/repro/X ->
# src/repro_torch/X; the reference's bench recorders (thread-reachable) map
# to a kernel wrapper module, the port's thread-reachable non-core code
PORT_PATHS = {
    "benchmarks/common.py": "src/repro_torch/kernels/common.py",
    "benchmarks/cache.py": "src/repro_torch/benchmarks/cache.py",
    "scripts/tool.py": "scripts/tool.py",
}


def port_path(rel):
    if rel.startswith("src/repro/"):
        return "src/repro_torch/" + rel[len("src/repro/"):]
    return PORT_PATHS[rel]


def mini_repo(root, files):
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return root


def findings_of(root, check):
    return [f for f in run_checks(root, [check]) if f.check == check]


def fields(findings):
    return [(f.check, f.line, f.obj, f.key, f.message) for f in findings]


def copy_port_tree(dest):
    """The port's files as the port's metrolint reads them."""
    shutil.copytree(REPO_ROOT / "src/repro_torch", dest / "src/repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (dest / "tests").mkdir()
    for p in sorted((REPO_ROOT / "tests").glob("test_torch_*.py")):
        shutil.copy(p, dest / "tests")
    return dest


# ------------------------------------------------ the reference's fixtures
EPOCH_VIOLATING = """
    class Framework:
        def drain(self, link):
            link.allocatable_gbps -= 1.0
            return link
    """
EPOCH_CLEAN = """
    class Framework:
        def drain(self, link):
            link.allocatable_gbps -= 1.0
            self.cluster.bump_epoch()
            return link
    """
EPOCH_SHIFTED = """
    # a comment that shifts every line


    class Framework:
        def drain(self, link):
            link.allocatable_gbps -= 1.0
    """
EXPERIMENT = """
    import dataclasses

    @dataclasses.dataclass(frozen=True)
    class Scenario:
        name: str
        build: object
        mode: str
        sim_config: object

        @property
        def label(self):
            return self.name

    @dataclasses.dataclass(frozen=True)
    class Policy:
        scheduler: str
        options: dict
    """
SIMULATOR = """
    import dataclasses

    @dataclasses.dataclass
    class SimConfig:
        seed: int
    """
CACHE_TMPL = """
    import dataclasses

    def _canon(obj):
        if dataclasses.is_dataclass(obj):
            return {{f.name: getattr(obj, f.name)
                    for f in dataclasses.fields(obj)}}
        return obj

    def fingerprint(scenario, policies, cfg):
        return {{
            "mode": scenario.mode,
            "built": scenario.materialize(),
            "scenario_cfg": _canon(scenario.sim_config),
            "policies": [{policy_expr} for p in policies],
            "cfg": _canon(cfg),
        }}
    """


def cache_files(policy_expr):
    return {"src/repro/core/experiment.py": EXPERIMENT,
            "src/repro/core/simulator.py": SIMULATOR,
            "benchmarks/cache.py": CACHE_TMPL.format(policy_expr=policy_expr)}


# (check, files, the keys the reference's tests expect)
PARITY_CASES = {
    "epoch-violating": ("epoch-soundness", {
        "src/repro/core/framework.py": EPOCH_VIOLATING}, ["no-bump"]),
    "epoch-clean": ("epoch-soundness", {
        "src/repro/core/framework.py": EPOCH_CLEAN}, []),
    "epoch-shifted": ("epoch-soundness", {
        "src/repro/core/framework.py": EPOCH_SHIFTED}, ["no-bump"]),
    "epoch-registry-store": ("epoch-soundness", {
        "src/repro/core/framework.py": """
            class Framework:
                def admit(self, job):
                    self.registry.jobs[job.name] = job
            """}, ["no-bump"]),
    "epoch-constructor": ("epoch-soundness", {
        "src/repro/core/cluster.py": """
            class Node:
                def __init__(self):
                    self.allocatable_gbps = 100.0
            """}, []),
    "determinism-set-iteration": ("determinism", {
        "src/repro/core/scoring.py": """
            def order(xs):
                pending = set(xs)
                out = []
                for x in pending:
                    out.append(x)
                return out
            """}, ["set-iteration:1"]),
    "determinism-sorted-set": ("determinism", {
        "src/repro/core/scoring.py": """
            def order(xs):
                pending = set(xs)
                out = []
                for x in sorted(pending):
                    out.append(x)
                return out
            """}, []),
    "determinism-unseeded-random": ("determinism", {
        "src/repro/core/fluid.py": """
            import numpy as np

            def jitter(n):
                return np.random.rand(n)

            def jitter_ok(n, seed):
                return np.random.default_rng(seed).random(n)
            """}, ["unseeded-random:1"]),
    "determinism-float32": ("determinism", {
        "src/repro/core/rotation.py": """
            import numpy as np

            def pack(x):
                return np.asarray(x, dtype=np.float32)
            """}, ["float32"]),
    "determinism-unpinned-module": ("determinism", {
        "src/repro/core/workload.py": """
            def order(xs):
                for x in set(xs):
                    yield x
            """}, []),
    "cache-keys-label-policies": ("cache-key-completeness",
                                  cache_files("p.name"),
                                  ["uncovered:policies"]),
    "cache-keys-canonicalized": ("cache-key-completeness",
                                 cache_files("_canon(p)"), []),
    "cache-keys-missing-knob": ("cache-key-completeness", {
        "src/repro/core/rotation.py": """
            def solve_link(view, link_id, *, mode="fast",
                           demand="planning", di_pre=16, g_t_ms=5.0,
                           e_t_frac=0.1, rotation_mode="intermediate",
                           cache=None):
                key = ("link", mode, demand, di_pre, g_t_ms, e_t_frac)
                return key
            """}, ["spec-drift", "spec-drift", "knobs"]),
    "cache-keys-renamed-solver": ("cache-key-completeness", {
        "src/repro/core/rotation.py": """
            def solve_link_renamed():
                return None
            """}, ["spec-drift"] * 3),
    "shared-state-unlocked-append": ("shared-state-race", {
        "benchmarks/common.py": """
            RECORDED: list = []

            def emit(row):
                RECORDED.append(row)
            """}, ["unlocked:RECORDED"]),
    "shared-state-locked-append": ("shared-state-race", {
        "benchmarks/common.py": """
            import threading

            _LOCK = threading.Lock()
            RECORDED: list = []

            def emit(row):
                with _LOCK:
                    RECORDED.append(row)
            """}, []),
    "shared-state-dict-slot": ("shared-state-race", {
        "src/repro/core/scoring.py": """
            _CACHE: dict = {}

            def memo(key):
                if key not in _CACHE:
                    _CACHE[key] = expensive(key)
                return _CACHE[key]
            """}, ["unlocked:_CACHE"]),
    "shared-state-out-of-scope": ("shared-state-race", {
        "scripts/tool.py": """
            ROWS: list = []

            def emit(row):
                ROWS.append(row)
            """}, []),
}


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_findings_equal_the_references(tmp_path, case):
    check, files, keys = PARITY_CASES[case]
    ref_root = mini_repo(tmp_path / "reference", files)
    port_root = mini_repo(tmp_path / "port",
                          {port_path(rel): src for rel, src in files.items()})
    want = [f for f in ref_run_checks(ref_root, [check]) if f.check == check]
    got = findings_of(port_root, check)
    assert sorted(f.key for f in want) == sorted(keys)
    assert fields(got) == fields(want)
    assert [f.path for f in got] == [port_path(f.path) for f in want]


class TestRegistry:
    def test_all_five_checks_registered(self):
        assert set(all_checks()) == {
            "epoch-soundness", "kernel-parity", "determinism",
            "cache-key-completeness", "shared-state-race"}

    def test_unknown_check_rejected(self, tmp_path):
        with pytest.raises(ValueError, match="unknown checks"):
            run_checks(tmp_path, ["no-such-check"])


# ------------------------------------------------------------ kernel-parity
KERNEL = """
    def my_fill(x):
        return x


    def _my_fill_bwd(x):
        return x


    def _bind(lib):
        return lib
    """
OPS = """
    from .mykernel import my_fill

    def fill(x):
        return my_fill(x)
    """
OPS_AUTOGRAD = """
    import torch

    from .mykernel import my_fill


    class _Fill({base}):
        @staticmethod
        def forward(ctx, x):
            return my_fill(x)


    def fill(x):
        return _Fill.apply(x)
    """
OPS_PRIVATE = """
    from .mykernel import _my_fill_bwd, my_fill

    def fill(x):
        return my_fill(x)

    def fill_bwd(x):
        return _my_fill_bwd(x)
    """
REF = """
    def my_fill_ref(x):
        return x
    """
CUDA_TEST = """
    import pytest

    from repro_torch.kernels import ops, ref

    pytestmark = pytest.mark.cuda


    def test_fill_parity():
        assert ops.fill(3) == ref.my_fill_ref(3)
    """


def kernel_repo(root, ops=OPS, tests=None, with_ref=True):
    files = {"src/repro_torch/kernels/mykernel.py": KERNEL,
             "src/repro_torch/kernels/ops.py": ops}
    if with_ref:
        files["src/repro_torch/kernels/ref.py"] = REF
    files.update(tests or {})
    return mini_repo(root, files)


def parity_keys(root):
    return [(f.obj, f.key) for f in findings_of(root, "kernel-parity")]


class TestKernelParity:
    def test_wired_and_tested_clean(self, tmp_path):
        root = kernel_repo(tmp_path, tests={
            "tests/test_torch_kernels_cuda.py": CUDA_TEST})
        assert parity_keys(root) == []

    def test_missing_parity_test_flagged(self, tmp_path):
        root = kernel_repo(tmp_path)
        found = findings_of(root, "kernel-parity")
        assert [(f.obj, f.key) for f in found] == [
            ("my_fill", "no-parity-test")]
        assert "cuda-marked" in found[0].message
        assert "TPU" not in found[0].message
        assert "interpret" not in found[0].message

    def test_unwired_kernel_flagged(self, tmp_path):
        root = kernel_repo(tmp_path, ops="def other():\n    return 1\n")
        found = findings_of(root, "kernel-parity")
        assert [(f.obj, f.key) for f in found] == [("my_fill", "unwired")]
        assert "CUDA/CPU dispatch" in found[0].message

    def test_missing_ref_module_flagged(self, tmp_path):
        root = kernel_repo(tmp_path, with_ref=False, tests={
            "tests/test_torch_kernels_cuda.py": CUDA_TEST})
        assert parity_keys(root) == [("my_fill", "no-ref-module")]

    @pytest.mark.parametrize("base", ["torch.autograd.Function",
                                      "autograd.Function", "Function"])
    def test_autograd_function_wiring(self, tmp_path, base):
        ops = OPS_AUTOGRAD.format(base=base)
        root = kernel_repo(tmp_path / "tested", ops=ops, tests={
            "tests/test_torch_kernels_cuda.py": CUDA_TEST})
        assert parity_keys(root) == []
        # wired (not "unwired") even without a test
        assert parity_keys(kernel_repo(tmp_path / "untested", ops=ops)) == [
            ("my_fill", "no-parity-test")]

    def test_plain_class_is_not_wiring(self, tmp_path):
        root = kernel_repo(tmp_path, ops=OPS_AUTOGRAD.format(base="object"))
        assert parity_keys(root) == [("my_fill", "unwired")]

    def test_private_kernel_ops_imports_is_checked(self, tmp_path):
        root = kernel_repo(tmp_path, ops=OPS_PRIVATE, tests={
            "tests/test_torch_kernels_cuda.py": CUDA_TEST})
        assert [fn.name for _m, fn in kernel_parity.kernels(Repo(root))] == [
            "my_fill", "_my_fill_bwd"]
        assert parity_keys(root) == [("_my_fill_bwd", "no-parity-test")]
        root = kernel_repo(tmp_path / "bwd", ops=OPS_PRIVATE, tests={
            "tests/test_torch_kernels_cuda.py": CUDA_TEST,
            "tests/test_torch_bwd_cuda.py": """
                import pytest

                from repro_torch.kernels import ops, ref

                @pytest.mark.cuda
                def test_bwd_parity():
                    assert ops.fill_bwd(3) == ref.my_fill_ref(3)
                """})
        assert parity_keys(root) == []

    def test_private_kernel_not_imported_is_not_checked(self, tmp_path):
        root = kernel_repo(tmp_path, tests={
            "tests/test_torch_kernels_cuda.py": CUDA_TEST})
        assert [fn.name for _m, fn in kernel_parity.kernels(Repo(root))] == [
            "my_fill"]

    @pytest.mark.parametrize("marks,decorator,ok", [
        ("pytestmark = pytest.mark.cuda", "", True),
        ("pytestmark = [pytest.mark.slow, pytest.mark.cuda]", "", True),
        ("", "@pytest.mark.cuda", True),
        ("pytestmark = pytest.mark.slow", "@pytest.mark.slow", False),
        ("", "", False),
    ])
    def test_cuda_marker_required(self, tmp_path, marks, decorator, ok):
        root = kernel_repo(tmp_path, tests={
            "tests/test_torch_kernels_cuda.py": f"""
import pytest

from repro_torch.kernels import ops, ref

{marks}


{decorator}
def test_fill_parity():
    assert ops.fill(3) == ref.my_fill_ref(3)
"""})
        assert parity_keys(root) == (
            [] if ok else [("my_fill", "no-parity-test")])

    def test_class_marker_counts(self, tmp_path):
        root = kernel_repo(tmp_path, tests={
            "tests/test_torch_kernels_cuda.py": """
                import pytest

                from repro_torch.kernels.mykernel import my_fill
                from repro_torch.kernels.ref import my_fill_ref


                @pytest.mark.cuda
                class TestFill:
                    def test_parity(self):
                        assert my_fill(3) == my_fill_ref(3)
                """})
        assert parity_keys(root) == []

    def test_cuda_call_without_port_ref_flagged(self, tmp_path):
        root = kernel_repo(tmp_path, tests={
            "tests/test_torch_kernels_cuda.py": """
                import pytest

                from repro_torch.kernels import ops

                pytestmark = pytest.mark.cuda


                def test_fill_smoke():
                    assert ops.fill(3) == 3
                """})
        assert parity_keys(root) == [("my_fill", "no-parity-test")]

    def test_reference_ref_does_not_count(self, tmp_path):
        root = kernel_repo(tmp_path, tests={
            "tests/test_torch_kernels_cuda.py": """
                import pytest

                from repro.kernels import ref
                from repro_torch.kernels import ops

                pytestmark = pytest.mark.cuda


                def test_fill_parity():
                    assert ops.fill(3) == ref.my_fill_ref(3)
                """})
        assert parity_keys(root) == [("my_fill", "no-parity-test")]

    def test_jax_interpret_call_does_not_count(self, tmp_path):
        root = kernel_repo(tmp_path, tests={
            "tests/test_torch_kernels.py": """
                import pytest

                from repro.kernels import ops as jops
                from repro_torch.kernels import ref

                pytestmark = pytest.mark.cuda


                def test_fill_parity():
                    assert jops.fill(3, interpret=True) == ref.my_fill_ref(3)
                """})
        assert parity_keys(root) == [("my_fill", "no-parity-test")]

    def test_only_port_test_files_count(self, tmp_path):
        root = kernel_repo(tmp_path, tests={
            "tests/test_kernels_cuda.py": CUDA_TEST})
        assert parity_keys(root) == [("my_fill", "no-parity-test")]


# -------------------------------------------------- the port's other rules
TORCH_DRAWS = ["rand", "randn", "randint", "randperm", "normal",
               "bernoulli", "multinomial"]


@pytest.mark.parametrize("draw", TORCH_DRAWS)
def test_torch_global_generator_draw_flagged(tmp_path, draw):
    root = mini_repo(tmp_path, {"src/repro_torch/core/simulator.py": f"""
        import torch

        def jitter(n, g):
            ok = torch.{draw}(n, generator=g)
            return ok, torch.{draw}(n)
        """})
    found = findings_of(root, "determinism")
    assert [(f.obj, f.key, f.line) for f in found] == [
        ("jitter", "unseeded-random:1", 6)]
    assert f"torch.{draw}" in found[0].message


def test_torch_float32_flagged(tmp_path):
    root = mini_repo(tmp_path, {"src/repro_torch/core/fluid.py": """
        import torch

        def pack(x):
            return torch.as_tensor(x, dtype=torch.float32)
        """})
    assert [f.key for f in findings_of(root, "determinism")] == ["float32"]


def kernel_cache_source(locked):
    """A kernel wrapper's per-device cache, as the fill and score wrappers
    keep their limits."""
    body = ("if index not in _LIMITS:\n"
            "    _LIMITS[index] = query()\n"
            "return _LIMITS[index]\n")
    if locked:
        body = "with _LOCK:\n" + textwrap.indent(body, "    ")
    return ("import threading\n"
            "from typing import Dict\n\n"
            "_LOCK = threading.Lock()\n"
            "_LIMITS: Dict[int, int] = {}\n\n\n"
            "def wrapper(index, query):\n" + textwrap.indent(body, "    "))


@pytest.mark.parametrize("path,locked,flagged", [
    ("src/repro_torch/kernels/mykernel.py", False, True),
    ("src/repro_torch/kernels/mykernel.py", True, False),
    ("src/repro_torch/_cuda_build.py", False, True),
    ("src/repro_torch/models/layers.py", False, False),
])
def test_kernel_wrapper_cache_needs_a_lock(tmp_path, path, locked, flagged):
    root = mini_repo(tmp_path, {path: kernel_cache_source(locked)})
    found = findings_of(root, "shared-state-race")
    assert [(f.obj, f.key) for f in found] == (
        [("wrapper", "unlocked:_LIMITS")] if flagged else [])


# ------------------------------------------------------------ prefix scoping
SET_ITERATION = """
    def order(xs):
        for x in set(xs):
            yield x
    """


@pytest.mark.parametrize("prefix,scanned", [
    ("", True),
    ("build/.bench_cache/tree/", False),
    ("build/tree/", False),
])
def test_only_the_ports_own_tree_is_scanned(tmp_path, prefix, scanned):
    root = mini_repo(tmp_path, {
        prefix + "src/repro_torch/core/scoring.py": SET_ITERATION,
        "src/repro/core/scoring.py": SET_ITERATION})
    found = findings_of(root, "determinism")
    assert [f.path for f in found] == (
        ["src/repro_torch/core/scoring.py"] if scanned else [])


def test_get_resolves_under_the_port(tmp_path):
    root = mini_repo(tmp_path, {
        "src/repro/kernels/ops.py": "X = 1\n",
        "src/repro_torch/kernels/ops.py": "X = 2\n",
        "tests/test_kernels.py": "X = 3\n",
        "tests/test_torch_kernels.py": "X = 4\n"})
    repo = Repo(root)
    assert repo.get("kernels/ops.py").relpath == \
        "src/repro_torch/kernels/ops.py"
    assert [m.relpath for m in repo.modules()] == [
        "src/repro_torch/kernels/ops.py", "tests/test_torch_kernels.py"]


# ----------------------------------------------------------- the real tree
PORT_KERNELS = ["flash_attention_fwd", "_flash_attention_bwd",
                "_lm_head_fwd", "_lm_head_dx", "_lm_head_dw",
                "metronome_fill", "metronome_score_multilink_batch",
                "metronome_score_multilink", "metronome_score_pairwise",
                "rg_lru_pallas", "_rg_lru_pallas_bwd"]


class TestRealTree:
    def test_every_kernel_wrapper_is_covered(self):
        assert [fn.name for _m, fn in kernel_parity.kernels(
            Repo(REPO_ROOT))] == PORT_KERNELS

    def test_port_clean_where_reference_finds_autograd_wiring_unwired(
            self, tmp_path):
        port = copy_port_tree(tmp_path / "port")
        assert fields(run_checks(port)) == []
        # the same files laid out as the reference package
        ref_layout = tmp_path / "as_reference"
        shutil.copytree(port / "src/repro_torch", ref_layout / "src/repro")
        shutil.copytree(port / "tests", ref_layout / "tests")
        found = ref_run_checks(ref_layout)
        assert [(f.check, f.path, f.obj, f.key) for f in found] == [
            ("kernel-parity", "src/repro/kernels/flash_attention.py",
             "flash_attention_fwd", "unwired"),
            ("kernel-parity", "src/repro/kernels/rg_lru.py",
             "rg_lru_pallas", "unwired")]

    @pytest.mark.parametrize("removed,flagged", [
        (["test_torch_kernels_cuda.py"],
         ["metronome_fill", "metronome_score_multilink_batch",
          "metronome_score_multilink", "metronome_score_pairwise"]),
        (["test_torch_dense_cuda.py", "test_torch_families_cuda.py",
          "test_torch_kernels_cuda.py", "test_torch_models_cuda.py",
          "test_torch_sharding_cuda.py", "test_torch_train_cuda.py"],
         PORT_KERNELS),
    ])
    def test_removing_the_cuda_tests_flags_their_kernels(
            self, tmp_path, removed, flagged):
        root = copy_port_tree(tmp_path)
        for name in removed:
            (root / "tests" / name).unlink()
        found = findings_of(root, "kernel-parity")
        assert [(f.obj, f.key) for f in found] == [
            (name, "no-parity-test") for name in flagged]


class TestBaselineContract:
    def test_committed_baseline_matches_fresh_run(self):
        baseline_path = REPO_ROOT / BASELINE_NAME
        assert baseline_path.exists()
        findings = run_checks(REPO_ROOT)
        baseline = load_baseline(baseline_path)
        new, suppressed, stale = apply_baseline(findings, baseline)
        assert new == [], "\n".join(f.render() for f in new)
        assert stale == [], [s.fingerprint for s in stale]
        assert len(suppressed) == len(baseline)

    def test_every_suppression_has_substantive_reason(self):
        for s in load_baseline(REPO_ROOT / BASELINE_NAME):
            assert len(s.reason) > 20, s.fingerprint
            assert s.reason != "baselined at adoption; triage", \
                s.fingerprint

    def test_reasonless_suppression_rejected(self, tmp_path):
        p = tmp_path / BASELINE_NAME
        p.write_text(json.dumps({"version": 1, "suppressions": [
            {"check": "determinism", "path": "x.py", "obj": "f",
             "key": "float32", "reason": ""}]}))
        with pytest.raises(ValueError, match="no\\s+reason"):
            load_baseline(p)


class TestCli:
    def test_clean_tree_exits_0(self, capsys):
        assert main(["--root", str(REPO_ROOT)]) == 0
        assert "0 new finding(s)" in capsys.readouterr().out

    def test_list_checks(self, capsys):
        assert main(["--list-checks"]) == 0
        assert len(capsys.readouterr().out.splitlines()) == len(all_checks())

    def test_findings_exit_1_then_baseline_round_trip(self, tmp_path,
                                                      capsys):
        root = mini_repo(tmp_path, {
            "src/repro_torch/core/scoring.py": SET_ITERATION})
        assert main(["--root", str(root), "--json"]) == 1
        doc = json.loads(capsys.readouterr().out)
        assert [f["key"] for f in doc["new"]] == ["set-iteration:1"]
        assert main(["--root", str(root), "--write-baseline"]) == 0
        assert (root / BASELINE_NAME).exists()
        assert main(["--root", str(root)]) == 0
        (root / "src/repro_torch/core/scoring.py").write_text("")
        assert main(["--root", str(root)]) == 1  # the entry is now stale
        assert "stale suppression" in capsys.readouterr().out

    @pytest.mark.parametrize("argv", [["--checks", "no-such-check"],
                                      ["--root", "no/such/dir"]])
    def test_usage_errors_exit_2(self, tmp_path, argv):
        if argv[0] == "--checks":
            argv = argv + ["--root", str(tmp_path)]
        assert main(argv) == 2


def test_imports_nothing_of_jax_or_the_reference():
    code = (
        "import sys\n"
        "from repro_torch.analysis.cli import main\n"
        f"rc = main(['--root', {str(REPO_ROOT)!r}])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro',\n"
        "                                    'torch'))\n"
        "print(rc, bad)\n")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
        text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO_ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == "0 []"
