"""A training cell: ``repro_torch``'s training loop on the cell's model and
traffic, timed, traced on demand, and held to the reference.

The loop is the one ``repro_torch.launch.train._train`` runs, built from
the program's public pieces: under ``use_rules`` on the 1 x 1 host mesh,
each step makes the step's batch on the host and copies it to the
device, waits on the ``CommGate`` (Metronome's actuator at the step
boundary, behind a fresh ``StopAndWaitController``), runs
``build_train_step``'s step, reads the loss back and reports the step's
time to the ``IterationReporter``.  The benchmark makes the weights and
batches itself (``inputs``); the program's data pipeline stays out.

Set-up builds the one training state and drives it through the cell's
first ``reference.CHECKED_STEPS`` steps by that same loop, reading what the
comparison needs from the state as it goes; the window then runs the
same state on.  After the window the state is freed and the reference
follows the checked steps (``reference``, ``judge``).
"""
from __future__ import annotations

import contextlib
import gc
import math
import time
from typing import Callable, Dict, List, Optional

import torch

from . import inputs, judge, reference, trace_read, workcount

LOOP_SPAN, ATTN_SPANS = trace_read.LOOP_SPAN, trace_read.ATTN_SPANS
LOOP_PARTS = ("batch", "gate", "step", "readback", "report")
# the traced steps of a ``--trace 1`` run: without the operators' input
# shapes (busy and idle time, spans), then with them (the products' split)
TRACE_STEPS, SHAPE_STEPS = 2, 1


def _flat(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _nest(flat: Dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def _leaf_norms(flat: Dict[str, torch.Tensor], scale: float = 1.0,
                base: Optional[Callable[[str], torch.Tensor]] = None
                ) -> Dict[str, float]:
    """Each leaf's float32 norm (of its difference from ``base(name)``,
    when given) times ``scale``, one layer at a time, under the names of
    ``reference.leaf_names``."""
    out = {}
    for name, t in flat.items():
        b = base(name) if base else None
        if name.startswith(reference.LAYER):
            sub = name[len(reference.LAYER):]
            for i in range(t.shape[0]):
                x = t[i].float() if b is None else t[i].float() - b[i].float()
                out[f"{reference.LAYER}{i}.{sub}"] = float(x.norm()) * scale
        else:
            x = t.float() if b is None else t.float() - b.float()
            out[name] = float(x.norm()) * scale
        del b
    return out


def model_config(model: dict):
    """The program's ``ModelConfig`` for the configuration file's fields."""
    from repro_torch.models.config import ModelConfig
    fields = dict(model)
    for key in ("dtype", "param_dtype", "logit_dtype"):
        if key in fields:
            fields[key] = getattr(torch, fields[key])
    return ModelConfig(**fields)


class AttentionProbe:
    """Wraps the program's attention entry points (``kernels.ops``'s
    ``flash_attention`` and ``flash_attention_bwd``) while it is entered:
    each call's shapes are recorded and, when ``spans`` is on, the call
    runs inside a ``record_function`` span of the benchmark's."""

    def __init__(self):
        self.calls: Dict[str, List[dict]] = {"fwd": [], "bwd": []}
        self.spans = False

    @staticmethod
    def _shapes(q, k, causal, window) -> dict:
        b, h, s, d = q.shape
        return {"b": b, "h": h, "hkv": k.shape[1], "s": s, "d": d,
                "causal": bool(causal), "window": int(window),
                "itemsize": q.element_size()}

    def __enter__(self):
        from repro_torch.kernels import ops
        self._ops = ops
        self._orig = (ops.flash_attention, ops.flash_attention_bwd)
        fwd, bwd = self._orig
        probe = self

        def flash_attention(q, k, v, causal=True, window=0):
            probe.calls["fwd"].append(probe._shapes(q, k, causal, window))
            with probe._span(ATTN_SPANS["fwd"]):
                return fwd(q, k, v, causal, window)

        def flash_attention_bwd(q, k, v, o, lse, do, causal=True, window=0):
            probe.calls["bwd"].append(probe._shapes(q, k, causal, window))
            with probe._span(ATTN_SPANS["bwd"]):
                return bwd(q, k, v, o, lse, do, causal, window)

        ops.flash_attention = flash_attention
        ops.flash_attention_bwd = flash_attention_bwd
        return self

    def __exit__(self, *exc):
        self._ops.flash_attention, self._ops.flash_attention_bwd = self._orig

    def _span(self, name: str):
        if self.spans:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()


def _kernel_launches() -> Dict[str, int]:
    """The program's own launch counters of the attention kernels."""
    from repro_torch.kernels import flash_attention as fa
    return {"fwd": fa.flash_attention_fwd.launches,
            "bwd": fa._flash_attention_bwd.launches}


class Loop:
    """The program's training loop on one state, a step at a time."""

    def __init__(self, model: dict, traffic: dict, seed: int,
                 device: torch.device, step_fn=None):
        from repro_torch.core.controller import StopAndWaitController
        from repro_torch.optim import AdamWConfig, adamw_init
        from repro_torch.runtime.comm_gate import CommGate, IterationReporter
        from repro_torch.runtime.steps import TrainState, build_train_step
        self.model, self.traffic, self.seed = model, traffic, seed
        self.device = device
        self.cfg = model_config(model)
        self.opt_cfg = AdamWConfig(**traffic["optimizer"])
        self.step_fn = step_fn or build_train_step(
            self.cfg, self.opt_cfg, traffic["n_micro"])
        params = _nest(inputs.make_weights(model, seed, device))
        self.state = TrainState(params, adamw_init(self.opt_cfg, params),
                                torch.zeros((), dtype=torch.int32,
                                            device=device))
        controller = StopAndWaitController()
        job = f"train-{model['name']}"
        self.gate = CommGate(controller, job=job)
        self.reporter = IterationReporter(controller, job, priority=1)
        self.step = 0
        self.t_last = time.perf_counter()
        self.spans = False

    def _part(self, name: str):
        if self.spans:
            return torch.profiler.record_function(LOOP_SPAN + name)
        return contextlib.nullcontext()

    def run_step(self) -> dict:
        """One step of the loop; the step's loss, metrics and host seconds
        in each part of the loop."""
        t = [time.perf_counter()]
        with self._part("batch"):
            host = inputs.make_batch(self.model, self.traffic, self.seed,
                                     self.step)
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in host.items()}
        t.append(time.perf_counter())
        with self._part("gate"):
            self.gate.wait_for_slot()
        t.append(time.perf_counter())
        with self._part("step"):
            self.state, metrics = self.step_fn(self.state, batch)
        t.append(time.perf_counter())
        with self._part("readback"):
            loss = float(metrics["loss"])
        t.append(time.perf_counter())
        with self._part("report"):
            self.reporter.report(t[-1] - self.t_last)
            self.t_last = time.perf_counter()
        t.append(self.t_last)
        self.step += 1
        return {"loss": loss, "metrics": metrics, "t0": t[0], "t_end": t[-1],
                "parts": {p: t[i + 1] - t[i]
                          for i, p in enumerate(LOOP_PARTS)}}

    def checked_steps(self, n: int) -> dict:
        """The first ``n`` steps, with the readings ``judge`` compares."""
        losses, first = [], {}
        for i in range(n):
            out = self.run_step()
            losses.append(out["loss"])
            if i == 0:
                first["grad_norm"] = float(out["metrics"]["grad_norm"])
                m = _flat(self.state.opt["m"])
                first["leaf_grad_norms"] = _leaf_norms(
                    m, 1.0 / (1.0 - self.opt_cfg.b1))
        specs = {s[0]: s for s in inputs.leaf_specs(self.model)}
        change = _leaf_norms(
            _flat(self.state.params),
            base=lambda name: inputs.make_leaf(self.model, self.seed,
                                               specs[name], self.device))
        return {"losses": losses, **first, "leaf_change_norms": change}


def program_readings(cell: dict, seed: int, device: torch.device) -> dict:
    """The program's readings over the cell's checked steps, by the loop
    a run's set-up drives, in a state of its own that is freed after."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import use_rules
    with use_rules(make_host_mesh(1, 1, device=device)):
        loop = Loop(cell["model"], cell["traffic"], seed, device)
        out = loop.checked_steps(reference.CHECKED_STEPS)
        del loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profiled(loop: Loop, probe: AttentionProbe, n: int, shapes: bool,
              scratch: str) -> dict:
    """``n`` steps under ``torch.profiler`` (host and device activity,
    with the operators' input shapes when ``shapes``) and the benchmark's
    spans on; the trace reduced by ``trace_read``."""
    import os
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if loop.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    for calls in probe.calls.values():
        calls.clear()
    loop.spans = probe.spans = True
    _sync(loop.device)
    with profile(activities=activities, record_shapes=shapes) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            loop.run_step()
        _sync(loop.device)
        wall = time.perf_counter() - t0
    loop.spans = probe.spans = False
    fd, path = tempfile.mkstemp(suffix=".json", dir=scratch)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        out = trace_read.read(path)
    finally:
        os.remove(path)
    out.update(steps=n, wall_s=wall,
               attention={k: list(v) for k, v in probe.calls.items()})
    return out


def _trace(loop: Loop, probe: AttentionProbe, traffic: dict,
           scratch: str) -> dict:
    """The traced steps: ``TRACE_STEPS`` steps without the operators'
    shapes, whose recording slows the host enough to idle the device, for
    the busy and idle time, the spans and the breakdown; then
    ``SHAPE_STEPS`` steps with them, for the products' split by shape
    (device times, which the host's pace does not move)."""
    out = _profiled(loop, probe, TRACE_STEPS, False, scratch)
    shaped = _profiled(loop, probe, SHAPE_STEPS, True, scratch)
    out.update(ops=shaped["ops"], ops_steps=shaped["steps"])
    return out


def run(cell: dict, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, log: Callable[[str], None],
        scratch: str) -> dict:
    """One run of a training cell: set-up, the window, the traced steps
    (``trace``), then the comparison.  Returns the end-to-end numbers,
    the record the per-layer metrics read, the device's peak memory and
    the comparison's table."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import use_rules
    model, traffic = cell["model"], cell["traffic"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    tokens = traffic["seq"] * traffic["seqs_per_step"]
    layers = inputs.family(model).attention_layers(model)
    shapes = {s[0]: s[1] for s in inputs.leaf_specs(model)}
    flops = workcount.train_step_flops(shapes, model, traffic["seq"],
                                       traffic["seqs_per_step"], layers)
    marks = [("entered", time.perf_counter())]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = make_host_mesh(1, 1, device=device)
    marks.append(("process group", time.perf_counter()))
    with use_rules(mesh), AttentionProbe() as probe:
        loop = Loop(model, traffic, seed, device)
        _sync(device)
        marks.append(("weights and state", time.perf_counter()))
        before = _kernel_launches()
        prog = loop.checked_steps(reference.CHECKED_STEPS)
        _sync(device)
        marks.append(("checked steps", time.perf_counter()))
        log("setup: " + ", ".join(
            f"{name} {t - prev:.2f} s" for (name, t), prev in
            zip(marks, [t_start] + [t for _, t in marks[:-1]])))
        launches = {k: v - before[k] for k, v in _kernel_launches().items()}
        per_step = {k: v / reference.CHECKED_STEPS
                    for k, v in launches.items()}
        want = {"fwd": 2 * layers * traffic["n_micro"],
                "bwd": layers * traffic["n_micro"]}
        masks = sorted({(c["causal"], c["window"], c["d"])
                        for c in probe.calls["fwd"]})
        log(f"attention launches a step {per_step} (remat: {want}); "
            f"(causal, window, D) of the calls {masks}; "
            f"checked losses {prog['losses']}")
        if device.type == "cuda" and per_step != want:
            raise RuntimeError(f"attention launches a step {per_step}, "
                               f"expected {want}")
        # Set-up's objects (some 270,000, most of them the imports': torch,
        # and sympy through DTensor) leave the collector's reach: a full
        # pass over them holds the host 0.14-0.20 s, and where one fell
        # into the window it idled the device for most of that, since the
        # host leads a step by only ~0.2 s
        gc.collect()
        gc.freeze()
        setup_peak = (torch.cuda.max_memory_allocated(device)
                      if device.type == "cuda" else 0)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        passes = [g["collections"] for g in gc.get_stats()]
        steps: List[dict] = []
        while True:
            steps.append(loop.run_step())
            if steps[-1]["t_end"] - steps[0]["t0"] >= seconds:
                break
        window_s = steps[-1]["t_end"] - steps[0]["t0"]
        window_peak = (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else 0)
        setup_s = steps[0]["t0"] - t_start
        passes = [g["collections"] - n
                  for g, n in zip(gc.get_stats(), passes)]
        log(f"window: {len(steps)} steps in {window_s:.4f} s, step s "
            f"{[round(s['t_end'] - s['t0'], 4) for s in steps]}, "
            f"collector passes by generation {passes}")
        record = {
            "tokens_per_step": tokens, "step_flops": flops,
            "vocab": model["vocab"],
            "window": {"steps": len(steps), "seconds": window_s,
                       "parts": {p: [s["parts"][p] for s in steps]
                                 for p in LOOP_PARTS}},
        }
        if trace:
            tr = record["trace"] = _trace(loop, probe, traffic, scratch)
            log(f"traced: busy {tr['busy_s']:.4f} s of {tr['wall_s']:.4f} s, "
                f"device s with no launch in the trace {tr['unplaced_s']}")
        failed = sum(not math.isfinite(s["loss"]) for s in steps)
        del loop, steps
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference.readings(model, traffic, seed, device)
    log(f"reference: {time.perf_counter() - t_ref:.2f} s")
    correct, table = judge.verdict(prog, ref, cell["limits"])
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    log(f"losses program {prog['losses']} reference {ref['losses']}")
    return {
        "correct": correct, "compare": table,
        "attempted": record["window"]["steps"], "failed": failed,
        "end_to_end": {
            "train_tokens_per_s": tokens * record["window"]["steps"]
            / record["window"]["seconds"],
            "peak_mem_gib": window_peak / 2 ** 30,
            "setup_s": setup_s,
        },
        "memory_peak_bytes": max(setup_peak, window_peak),
        "record": record,
    }
