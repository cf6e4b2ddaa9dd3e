"""End-to-end training driver on the PyTorch port (``examples/train_lm.py``
with ``repro_torch``): the full substrate on one page.

Trains a language model with the production code paths -- synthetic data
pipeline, the train step under sharding rules (grad accumulation + remat),
AdamW, async checkpointing with restart, and the Metronome integration
(comm gate + iteration reporting, exactly the paper's modified-DDP hookup).

Default is a ~8M-parameter model so the demo finishes in minutes on the
host; ``--preset 100m`` selects the ~110M-parameter configuration (same
code path, bigger shapes).  The mesh is 1 x 1 (``make_host_mesh``): the
rules resolve, nothing is split.

Run:  PYTHONPATH=src python examples_torch/train_lm.py --steps 300
      [--device cpu]
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch import _device
from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.core.controller import StopAndWaitController
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import param_count
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.comm_gate import CommGate, IterationReporter
from repro_torch.runtime.steps import (TrainState, build_train_step,
                                       init_train_state)
from repro_torch.sharding import use_rules

PRESETS = {
    # ~8M params: fast host demo
    "tiny": ModelConfig(name="lm-tiny", family="dense", n_layers=4,
                        d_model=256, n_heads=4, n_kv=2, d_ff=1024,
                        vocab=8192),
    # ~110M params: the assignment's "~100M model" (GPT-2-small-like)
    "100m": ModelConfig(name="lm-100m", family="dense", n_layers=12,
                        d_model=768, n_heads=12, n_kv=4, d_ff=2048,
                        vocab=32000),
}


def main(argv=None, init_params=None):
    """Run the demo; returns each step's loss.  ``init_params`` starts from
    the given parameters (on the device) instead of a random draw."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=PRESETS, default="tiny")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--crash-at", type=int, default=0,
                    help="simulate a failure at this step (restart demo)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = PRESETS[args.preset]
    dev = _device.resolve(args.device)  # raises where the card is missing
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    ds = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=0)
    mesh = make_host_mesh(1, 1, device=dev)

    # Metronome hookup: in a multi-tenant cluster the scheduler would assign
    # this job an offset; standalone the gate is a no-op but the code path
    # is identical to the gated run.
    controller = StopAndWaitController()
    gate = CommGate(controller, job="train-lm")
    reporter = IterationReporter(controller, "train-lm", priority=1)

    losses = []
    with use_rules(mesh):
        if init_params is None:
            gen = torch.Generator(device=dev.type).manual_seed(0)
            state = init_train_state(cfg, opt_cfg, gen, dev)
        else:
            state = TrainState(init_params, adamw_init(opt_cfg, init_params),
                               torch.zeros((), dtype=torch.int32, device=dev))
        print(f"model: {cfg.name}  params={param_count(state.params):,}")
        step_fn = build_train_step(cfg, opt_cfg, args.n_micro)

        mgr = CheckpointManager(args.ckpt_dir, keep_n=2)
        start = 0
        if latest_step(args.ckpt_dir) is not None:
            state, start, _ = mgr.restore_latest(state)
            print(f"[fault-tolerance] resumed from checkpoint at step {start}")

        t_last = time.perf_counter()
        for step in range(start, args.steps):
            if args.crash_at and step == args.crash_at:
                print(f"[fault-tolerance] simulated crash at step {step}; "
                      "re-run the same command to resume")
                return losses
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in ds.batch_at(step).items()}
            gate.wait_for_slot()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])  # block: honest per-step timing
            losses.append(loss)
            dt = time.perf_counter() - t_last
            t_last = time.perf_counter()
            reporter.report(dt)
            if step % 20 == 0 or step == args.steps - 1:
                print(f"step {step:4d}  loss {loss:.4f}  "
                      f"lr {float(metrics['lr']):.2e}  {dt*1e3:.0f} ms/it",
                      flush=True)
            if (step + 1) % 100 == 0:
                mgr.save(step + 1, state)
        mgr.save(args.steps, state)
        mgr.wait()
    print("done — loss should have dropped by >1 nat from ~ln(vocab)")
    return losses


if __name__ == "__main__":
    main()
