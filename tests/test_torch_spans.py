"""The port's spans (``repro_torch._spans``) in the train step and AdamW, on
the CPU: none is built while no profiler records; under
``torch.profiler`` a step of the dense and griffin smoke configs at
``n_micro=2`` emits its forward and backward once a micro-batch, its
gradient sum at least that often and AdamW's update once, in the step's
order and none overlapping another; and the profiler leaves the step's
numbers bit for bit as they are.  ``chip_smoke.py``, which sums a
profiled step's device events, counts no span among them."""
import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import _tree, configs
from repro_torch.data import SyntheticLM
from repro_torch.optim import AdamWConfig, adamw, adamw_init, adamw_update
from repro_torch.runtime import steps

ROOT = Path(__file__).resolve().parents[1]
ARCHS = {"dense": "internlm2_20b", "griffin": "recurrentgemma_2b"}
N_MICRO = 2
# the sum's buffers, each micro-batch's forward, backward and add, the
# sum's division, and AdamW's update
ORDER = ([steps.ACCUMULATE_SPAN]
         + [steps.FORWARD_SPAN, steps.BACKWARD_SPAN,
            steps.ACCUMULATE_SPAN] * N_MICRO
         + [steps.ACCUMULATE_SPAN, adamw.UPDATE_SPAN])


def _step_inputs(arch):
    """A fresh train state (the same on every call), its step function and
    a batch of 4 sequences of 16 tokens."""
    cfg = configs.get_smoke_config(ARCHS[arch])
    opt = AdamWConfig(lr=1e-3, warmup_steps=0)
    state = steps.init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                                   "cpu")
    batch = {k: torch.as_tensor(v) for k, v in
             SyntheticLM(cfg.vocab, 16, 4, seed=0).batch_at(0).items()}
    return state, steps.build_train_step(cfg, opt, N_MICRO), batch


def _spans(prof, tmp_path):
    """[name, start µs, end µs] of every ``repro_torch.`` span in the
    profiler's trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [[e["name"], e["ts"], e["ts"] + e["dur"]] for e in events
            if e.get("cat") == "user_annotation"
            and e["name"].startswith("repro_torch.")]


@pytest.fixture
def count_record_functions(monkeypatch):
    """Counts the ``record_function`` objects built, under either of the
    names torch exports the class by."""
    made = []
    real = torch.profiler.record_function

    def counting(*args, **kwargs):
        made.append(args[0] if args else kwargs.get("name"))
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    return made


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_no_span_is_built_without_a_profiler(arch, count_record_functions):
    state, step, batch = _step_inputs(arch)
    step(state, batch)
    assert count_record_functions == []
    # the count sees the spans where a profiler records
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, batch)
    assert count_record_functions == ORDER


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_a_profiled_step_emits_its_spans_inside_the_step(arch, tmp_path):
    state, step, batch = _step_inputs(arch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    spans = sorted(_spans(prof, tmp_path), key=lambda s: s[1])
    names = [name for name, _, _ in spans]
    assert names.count(steps.FORWARD_SPAN) == N_MICRO
    assert names.count(steps.BACKWARD_SPAN) == N_MICRO
    assert names.count(steps.ACCUMULATE_SPAN) >= N_MICRO
    assert names.count(adamw.UPDATE_SPAN) == 1
    assert names == ORDER
    # one after another, inside the step: each ends before the next starts
    assert all(b <= a for (_, _, b), (_, a, _) in zip(spans, spans[1:]))


def test_adamw_update_alone_emits_its_span(tmp_path):
    cfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    g = torch.Generator().manual_seed(1)
    params = {"a": torch.randn(8, 4, generator=g),
              "b": torch.randn(3, generator=g)}
    grads = {k: torch.randn(v.shape, generator=g) for k, v in params.items()}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        adamw_update(cfg, params, grads, adamw_init(cfg, params))
    assert [name for name, _, _ in _spans(prof, tmp_path)] == [
        adamw.UPDATE_SPAN]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_the_profiler_changes_no_number_of_the_step(arch):
    runs = []
    for profiled in (False, True):
        state, step, batch = _step_inputs(arch)
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]):
                runs.append(step(state, batch))
        else:
            runs.append(step(state, batch))
    (plain, plain_metrics), (traced, traced_metrics) = runs
    assert int(plain.step) == int(traced.step) == 1
    for tree in (lambda s: s.params, lambda s: s.opt["m"],
                 lambda s: s.opt["v"]):
        for a, b in zip(_tree.leaves(tree(plain)), _tree.leaves(tree(traced))):
            assert torch.equal(a, b)
    assert set(plain_metrics) == set(traced_metrics)
    for k, v in plain_metrics.items():
        assert torch.equal(v, traced_metrics[k]), k


def _chip_smoke():
    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", ROOT / "chip_smoke.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
    return sys.modules["chip_smoke"]


def test_chip_smoke_counts_no_span_as_device_time():
    """A span comes back from the profiler as a CUDA event whose time is
    that of the kernels inside it; chip_smoke's busy time and its split
    by source leave it out."""
    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU
    kernel = SimpleNamespace(device_type=cuda, is_user_annotation=False)
    span = SimpleNamespace(device_type=cuda, is_user_annotation=True)
    op = SimpleNamespace(device_type=cpu, is_user_annotation=False)
    host_span = SimpleNamespace(device_type=cpu, is_user_annotation=True)
    assert _chip_smoke()._device_events([kernel, span, op, host_span]) == [
        kernel]


@pytest.mark.parametrize("rows", ["events", "key_averages"])
def test_a_profiles_rows_tell_a_span_from_the_work(rows):
    """The flag chip_smoke reads, on both kinds of row it reads."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(adamw.UPDATE_SPAN):
            torch.ones(4).add_(1)
    flags = {ev.key: ev.is_user_annotation for ev in getattr(prof, rows)()}
    assert flags[adamw.UPDATE_SPAN] is True
    assert flags["aten::add_"] is False
