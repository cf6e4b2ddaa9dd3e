"""The port's Score phase and rotation planner against the JAX package's.

Geometry, scoring, rotation's ``numpy`` backend, the scheduler and the
controller are float64 host code carried over verbatim, with networkx
replaced by ``repro_torch.core._graph``.  So on every pinned snapshot (S1-S5,
F2, F4, J1) the port must place every task on the same node and give the
controller the same global offsets and per-link schemes EXACTLY.  The
``kernel`` backend, which on the CPU runs the score kernel's plain float32
version, must give the ``numpy`` shifts where the reference's own tests
hold them (J1, F4).
"""
import numpy as np
import pytest

from repro.configs import metronome_testbed as rtb
from repro.core import rotation as rrot
from repro.core.contention import LinkView as RLinkView
from repro.core.controller import StopAndWaitController as RController
from repro.core.framework import SchedulingFramework as RFramework
from repro.core.scheduler import MetronomePlugin as RPlugin
from repro_torch.configs import metronome_testbed as tb
from repro_torch.core import rotation
from repro_torch.core.contention import LinkView
from repro_torch.core.controller import StopAndWaitController
from repro_torch.core.framework import SchedulingFramework
from repro_torch.core.scheduler import MetronomePlugin
from repro_torch.core.topology import is_uplink

PINNED = ("S1", "S2", "S3", "S4", "S5", "F2", "F4", "J1")


def _schedule(testbed, framework, plugin, controller, sid, joint=True,
              n_iterations=50):
    cluster, wls, _ = testbed.make_snapshot(sid, n_iterations=n_iterations)
    ctrl = controller(joint=joint)
    fw = framework(cluster, plugin(controller=ctrl, joint=joint))
    admitted = [fw.schedule_workload(wl) for wl in wls]
    ctrl.run_offline_recalculation(fw.registry, cluster)
    return cluster, fw, ctrl, admitted


def _both(sid, joint=True):
    ref = _schedule(rtb, RFramework, RPlugin, RController, sid, joint)
    port = _schedule(tb, SchedulingFramework, MetronomePlugin,
                     StopAndWaitController, sid, joint)
    return ref, port


@pytest.mark.parametrize("joint", [True, False], ids=["joint", "legacy"])
@pytest.mark.parametrize("sid", PINNED)
def test_placements_offsets_and_schemes_equal(sid, joint):
    (_, rfw, rctrl, radm), (_, fw, ctrl, adm) = _both(sid, joint)
    assert adm == radm
    assert ({u: t.node for u, t in fw.registry.tasks.items()}
            == {u: t.node for u, t in rfw.registry.tasks.items()})
    assert ctrl.global_offsets_ms == rctrl.global_offsets_ms
    assert set(ctrl.links) == set(rctrl.links)
    for lid in rctrl.links:
        a, b = ctrl.links[lid].scheme, rctrl.links[lid].scheme
        assert a.jobs == b.jobs
        assert np.array_equal(a.shifts_slots, b.shifts_slots)
        assert a.base_ms == b.base_ms
        assert a.score == b.score
        assert a.injected_ms == b.injected_ms


def _joint_inputs(sid):
    (rcl, rfw, _, _), (cl, fw, _, _) = _both(sid)
    rview = RLinkView.from_registry(rcl, rfw.registry)
    view = LinkView.from_registry(cl, fw.registry)
    if sid == "F4":
        links = [l for l in view.planning_links() if is_uplink(l)]
    else:
        links = [l for l in view.planning_links()
                 if rotation.solve_link(view, fw.registry, l)[1] is not None]
    return (rview, rfw.registry), (view, fw.registry), links


@pytest.mark.parametrize("sid", ("J1", "F4"))
def test_joint_solve_numpy_equals_reference(sid):
    (rview, rreg), (view, reg), links = _joint_inputs(sid)
    want = rrot.joint_solve(rview, rreg, links, backend="numpy")
    got = rotation.joint_solve(view, reg, links, backend="numpy")
    assert got.jobs == want.jobs
    assert np.array_equal(got.shifts, want.shifts)
    assert got.score == want.score and got.psi == want.psi
    assert got.offsets_ms == want.offsets_ms
    assert got.n_evaluated == want.n_evaluated


@pytest.mark.parametrize("sid", ("J1", "F4"))
def test_joint_solve_kernel_on_cpu_gives_numpy_shifts(sid):
    _, (view, reg), links = _joint_inputs(sid)
    res_np = rotation.joint_solve(view, reg, links, backend="numpy")
    res_k = rotation.joint_solve(view, reg, links, backend="kernel",
                                 device="cpu")
    assert res_np.feasible
    assert np.array_equal(res_np.shifts, res_k.shifts)
    assert res_np.score == pytest.approx(res_k.score, abs=1e-4)


def test_joint_solve_batch_kernel_on_cpu_matches_numpy():
    _, (view, reg), links = _joint_inputs("J1")
    specs = [(view, links), (view, links)]
    res_np = rotation.joint_solve_batch(specs, reg, backend="numpy")
    res_k = rotation.joint_solve_batch(specs, reg, backend="kernel",
                                       device="cpu")
    for a, b in zip(res_np, res_k):
        assert np.array_equal(a.shifts, b.shifts)
        assert a.score == pytest.approx(b.score, abs=1e-4)


def test_plan_cache_keys_the_kernel_device(monkeypatch):
    """A plain-version (CPU) result is never served to a CUDA request: the
    request misses the cache and goes to the device (which raises here)."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, (view, reg), links = _joint_inputs("J1")
    cache = rotation.PlanCache()
    for _ in range(2):
        rotation.joint_solve(view, reg, links, backend="kernel",
                             device="cpu", cache=cache)
    assert cache.hits == 1
    with pytest.raises(RuntimeError, match="is_available"):
        rotation.joint_solve(view, reg, links, backend="kernel",
                             device="cuda", cache=cache)
    assert cache.hits == 1
