"""The port's imperfect-information control plane against the JAX package's.

``tests/test_robustness.py`` holds the reference to its own contracts: the
telemetry channel (sample-and-hold, staleness, noise, dropout), link and
host fault injection, ``strict_events`` and the loops' parity.  Here the
same inputs go through both packages:

  * the fault snapshots R1 and R2 (flapping uplink / host) and a noisy,
    stale, lossy telemetry channel on the dynamic snapshot D1, each through
    the array and the legacy event loop: with the float64 ``python`` fluid
    backend the results JSON must equal the reference's exactly;
  * a transparent channel (continuous, or sampled without distortion) must
    give the reference's results and the port's own no-channel results;
  * a ``strict_events`` stream with bad values and unknown targets must
    raise ``EventValidationError`` with the same problems in both;
  * ``TelemetryView`` samples at (link, slot) pairs, which pins the
    per-(link, slot) ``SeedSequence(seed, spawn_key=(1, link, k))`` stream;
  * the noisy run with the ``kernel`` backend on the CPU (the fill kernel's
    plain float32 version) against the reference's float32 ``jnp``: the
    same finished jobs and ``total_completion_ms`` within 1e-6 relative.
"""
import dataclasses
import math

import pytest

from repro.configs import metronome_testbed as rtb
from repro.core import cluster as rcluster
from repro.core import events as revents
from repro.core import experiment as rexp
from repro.core import simulator as rsim
from repro.core import telemetry as rtel
from repro.core import workload as rworkload
from repro_torch.configs import metronome_testbed as tb
from repro_torch.core import (cluster, events, experiment, simulator,
                              telemetry, workload)

# the reference's robustness settings (tests/test_robustness.py)
SIM_KW = dict(duration_ms=20_000.0, seed=3, jitter_std=0.01)
FAULT_KW = dict(n_iterations=30, start_ms=3_000.0, period_ms=6_000.0,
                down_ms=1_000.0, n_cycles=2)
NOISY = dict(sample_period_ms=500.0, noise_std=0.15, staleness_ms=250.0,
             dropout=0.1)

REF = dict(tb=rtb, exp=rexp, sim=rsim, tel=rtel, ev=revents, cl=rcluster,
           wl=rworkload, cfg={})
PORT = dict(tb=tb, exp=experiment, sim=simulator, tel=telemetry, ev=events,
            cl=cluster, wl=workload, cfg={"device": "cpu"})


def _scenario(pkg, case):
    if case in tb.FAULT_SNAPSHOTS:
        return pkg["tb"].fault_scenario(case, **FAULT_KW)
    return pkg["tb"].dynamic_scenario("D1", n_iterations=30)


def _run(pkg, case, loop="array", backend="python", channel=None):
    tel = None if channel is None else pkg["tel"].TelemetryChannel(**channel)
    cfg = pkg["sim"].SimConfig(fluid_backend=backend, event_loop=loop,
                               telemetry=tel, **SIM_KW, **pkg["cfg"])
    policy = pkg["exp"].Policy("metronome")
    return pkg["exp"].run(_scenario(pkg, case), policy, cfg)


@pytest.mark.parametrize("loop", ["array", "legacy"])
@pytest.mark.parametrize("case,channel", [("R1", None), ("R2", None),
                                          ("D1", NOISY)],
                         ids=["R1", "R2", "D1-noisy"])
def test_python_backend_results_json_equal(case, channel, loop):
    want = _run(REF, case, loop, channel=channel).to_json_dict()
    assert _run(PORT, case, loop, channel=channel).to_json_dict() == want
    if channel is not None:  # the channel reached the controller
        assert want != _run(REF, case, loop).to_json_dict()


@pytest.mark.parametrize("channel", [{"sample_period_ms": 0.0},
                                     {"sample_period_ms": 1000.0}],
                         ids=["continuous", "sampled"])
def test_transparent_channel_is_the_oracle(channel):
    got = _run(PORT, "D1", channel=channel).to_json_dict()
    assert got == _run(PORT, "D1").to_json_dict()
    assert got == _run(REF, "D1", channel=channel).to_json_dict()


def _strict_problems(pkg):
    ev, cl = pkg["ev"], pkg["cl"]
    nodes = [cl.Node(f"n{i}", cl.Resources(cpu=32, mem=256, gpu=4),
                     bw_gbps=25.0) for i in range(2)]
    job = pkg["wl"].make_job("j", n_tasks=2, period_ms=100, duty=0.4,
                             bw_gbps=20.0, n_iterations=5)
    stream = [ev.TrafficChange(100.0, job="j", duty_mult=math.nan),
              ev.HostFailure(200.0, host="ghost"),
              ev.BackgroundFlowChange(300.0, link="n0", rate_gbps=math.inf),
              ev.LinkCapacityChange(350.0, link="n1", allocatable_gbps=-5.0),
              ev.LinkFailure(400.0, link="ghost"),
              ev.TrafficChange(-5.0, job="nobody", duty_mult=1.5)]
    cfg = pkg["sim"].SimConfig(duration_ms=3_000.0, seed=0, jitter_std=0.0,
                               fluid_backend="python", strict_events=True,
                               **pkg["cfg"])
    sim = pkg["sim"].ClusterSimulator(cl.Cluster(nodes), [job], cfg,
                                      events=stream)
    with pytest.raises(ev.EventValidationError) as exc:
        sim.run()
    return exc.value


def test_strict_events_raise_the_same_problems():
    want, got = _strict_problems(REF), _strict_problems(PORT)
    assert [dataclasses.asdict(p) for p in got.problems] == \
        [dataclasses.asdict(p) for p in want.problems]
    assert {p.category for p in got.problems} == {"bad-value",
                                                  "unknown-target"}
    assert str(got) == str(want)


def _samples(pkg):
    cl = pkg["cl"]
    nodes = [cl.Node(f"n{i}", cl.Resources(cpu=32, mem=256, gpu=4),
                     bw_gbps=25.0) for i in range(3)]
    world = cl.Cluster(nodes)
    chan = pkg["tel"].TelemetryChannel(sample_period_ms=100.0,
                                       noise_std=0.2, staleness_ms=150.0,
                                       dropout=0.2)
    view = pkg["tel"].TelemetryView(world, chan, seed=11)
    out = []
    for k in range(12):
        if k == 5:
            world.node("n1").allocatable_gbps = 10.0
            view.record_change(520.0, ["n1"])
        view.now_ms = k * 100.0 + 40.0
        for link in ("n2", "n0", "n1"):  # out of order: per-(link, slot)
            out.append((link, k, view.link_alloc(link),
                        view.fluctuation(link)))
    return out


def test_telemetry_samples_equal():
    want = _samples(REF)
    assert _samples(PORT) == want
    assert len({v for _, _, v, _ in want}) > 10  # noise reached the samples


def _finished(res):
    return {j for j, t in res.sim.finish_times_ms.items()
            if not math.isnan(t)}


def test_noisy_kernel_on_cpu_tracks_the_reference_jnp():
    want = _run(REF, "D1", backend="jnp", channel=NOISY)
    got = _run(PORT, "D1", backend="kernel", channel=NOISY)
    assert got.accepted == want.accepted
    assert got.placements == want.placements
    assert _finished(got) == _finished(want)
    assert got.sim.total_completion_ms == pytest.approx(
        want.sim.total_completion_ms, rel=1e-6)
