"""The plain reference against the program's CPU path, and the
comparison against its control and the planted faults.

At the program's smoke widths in float32 the reference and the program
compute the same steps: the losses, the gradient norms and the updated
parameters agree to float32 rounding.  In the configuration's precision
the program passes the limits of those sizes (``conftest.TINY_LIMITS``,
set by the cells' rule), while the reference in the precision below (its
float8 control) and each fault a training cell can have fail one of
them."""
import time

import pytest
import torch

from perfbench import faults, harness, inputs, judge, reference, spec
from perfbench import train_cell
from conftest import tiny

CELLS = ["internlm2-20b.train-4k", "mistral-7b.train-4k"]
F32 = dict(dtype="float32", param_dtype="float32")


@pytest.mark.parametrize("name", CELLS)
def test_reference_and_program_agree_in_float32(name, cpu):
    cell = tiny(spec.cell(name), **F32)
    model, traffic = cell["model"], cell["traffic"]
    prog = train_cell.program_readings(cell, 3, cpu)
    ref = reference.readings(model, traffic, 3, cpu)
    got = judge.numbers(prog, ref)
    assert max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"])) \
        < 2e-5
    assert got["gnorm1"] < 1e-5 and got["grad1"] < 1e-4, got
    assert got["change"] < 1e-3, got


def test_updated_parameters_agree_in_float32(cpu):
    cell = tiny(spec.cell(CELLS[0]), **F32)
    model, traffic = cell["model"], cell["traffic"]
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import use_rules
    with use_rules(make_host_mesh(1, 1, device=cpu)):
        loop = train_cell.Loop(model, traffic, 4, cpu)
        loop.checked_steps(reference.CHECKED_STEPS)
    prog = train_cell._flat(loop.state.params)
    ref = reference.Reference(model, traffic, 4, cpu)
    for step in range(reference.CHECKED_STEPS):
        ref.train_step({k: torch.as_tensor(v) for k, v in
                        inputs.make_batch(model, traffic, 4, step).items()})
    p0 = inputs.make_weights(model, 4, cpu)
    for name, t in prog.items():
        if name.startswith("layers."):
            sub = name[len("layers."):]
            r = torch.stack([ref.params[f"layers.{i}.{sub}"]
                             for i in range(t.shape[0])])
        else:
            r = ref.params[name]
        moved = float((r - p0[name]).norm())
        assert float((t - r).norm()) <= 1e-3 * max(moved, 1e-12), name


@pytest.mark.parametrize("name", CELLS)
def test_the_program_passes_the_tiny_limits(name, cpu, tmp_path):
    cell = tiny(spec.cell(name))
    out = harness.execute(cell, 2 ** 31 + 21, 0.2, False, cpu,
                          time.perf_counter(), str(tmp_path))
    assert out["correct"], out["compare"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [31, 32, 33])
def test_the_control_fails_the_tiny_limits(name, seed, cpu):
    cell = tiny(spec.cell(name))
    model, traffic = cell["model"], cell["traffic"]
    ref = reference.readings(model, traffic, seed, cpu)
    ctrl = reference.readings(model, traffic, seed, cpu,
                              reference.fp8_cast)
    ok, table = judge.verdict(ctrl, ref, cell["limits"])
    assert not ok, table


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_run_with_a_fault_under_the_timed_path_is_not_correct(
        fault, name, cpu, tmp_path):
    """The run as ``run.py`` drives it, but for the look for a chip."""
    cell = tiny(spec.cell(name))
    with faults.FAULTS[fault]():
        out = harness.execute(cell, 2 ** 31 + 41, 0.2, False, cpu,
                              time.perf_counter(), str(tmp_path))
    assert out["correct"] is False, out["compare"]
