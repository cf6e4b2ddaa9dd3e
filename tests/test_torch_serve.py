"""The port's serving path against the JAX package's, and its imports.

``serve_requests`` on the float32 smoke config gives the same greedy tokens
as a JAX ``prefill`` + ``decode_step`` loop on the same weights (carried
over with ``params_from_jax``) and the same numpy prompts, and the port's
stop-and-wait controller receives gen - 1 reports per batch.
"""
import dataclasses
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro import configs as jconfigs
from repro import models as jmodels
from repro.runtime.steps import build_serve_step as jbuild_serve_step
from repro_torch import configs as tconfigs
from repro_torch.core.controller import StopAndWaitController
from repro_torch.launch import serve
from repro_torch.models import params_from_jax
from repro_torch.runtime.comm_gate import IterationReporter

ROOT = Path(__file__).resolve().parents[1]
ARCH = "recurrentgemma-2b"


class CountingController(StopAndWaitController):
    def __init__(self):
        super().__init__()
        self.reports = []

    def report_iteration(self, job, iter_ms):
        self.reports.append((job, iter_ms))
        return super().report_iteration(job, iter_ms)


def _jax_serve(params, cfg, prompts, gen):
    step = jax.jit(jbuild_serve_step(cfg))
    out = []
    for p in prompts:
        logits, cache = jmodels.prefill(params, cfg, jnp.asarray(p, jnp.int32),
                                        max_len=p.shape[1] + gen)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        toks = [tok]
        for _ in range(gen - 1):
            logits, cache = step(params, cache, tok)
            tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
            toks.append(tok)
        out.append(np.concatenate([np.asarray(t) for t in toks], axis=1))
    return out


@pytest.mark.parametrize("prompt_len", [10, 20])
def test_serve_requests_matches_the_jax_loop(prompt_len):
    gen, batch = 5, 2
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               dtype=jnp.float32, param_dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH),
                               dtype=torch.float32, param_dtype=torch.float32)
    jparams, _ = jmodels.init_model(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jparams), tcfg,
        "cpu")
    prompts = np.random.default_rng(prompt_len).integers(
        0, jcfg.vocab, (4, prompt_len))
    want = _jax_serve(jparams, jcfg, np.split(prompts, 2), gen)

    ctl = CountingController()
    reporter = IterationReporter(ctl, "serve-test", priority=1)
    res = serve.serve_requests(tparams, tcfg,
                               list(torch.as_tensor(prompts).split(batch)),
                               gen, reporter)
    assert res.finite
    assert len(res.tokens) == 2 and len(res.prefill_s) == 2
    for got, w in zip(res.tokens, want):
        np.testing.assert_array_equal(got.numpy(), w)
    assert len(ctl.reports) == len(res.step_s) == 2 * (gen - 1)
    assert all(job == "serve-test" and ms > 0 for job, ms in ctl.reports)


def test_serve_main_runs_the_smoke_config_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--requests", "3", "--batch", "2",
                "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out
    assert "batch of 2 done (2/3)" in out and "batch of 1 done (3/3)" in out
    assert "served 3 requests, 9 tokens" in out


def test_serve_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        serve.main(["--requests", "1"])


def test_port_imports_with_jax_and_the_reference_blocked():
    """Every module of repro_torch imports with ``jax`` and ``repro``
    poisoned in ``sys.modules`` (a fresh interpreter, so nothing is
    cached)."""
    names = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    assert "repro_torch.launch.serve" in names
    assert "repro_torch.models.convert" in names
    code = ("import importlib, sys\n"
            "for banned in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[banned] = None\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "print('ok', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
