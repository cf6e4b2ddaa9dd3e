"""Training entry point: ``python -m repro_torch.launch.train``

The port's counterpart of ``repro.launch.train``: single-process end-to-end
training with the full substrate -- synthetic data pipeline, AdamW,
checkpointing/restart, Metronome comm-gating + iteration reporting.
Without ``--full`` it trains the architecture's smoke config; ``--full``
takes the full-size config on one card.  Both run under the sharding rules
of a 1 x 1 host mesh (``launch.mesh.make_host_mesh``), as the reference's
smoke path does: on one rank the rules resolve and nothing is split.  The
reference's ``--full`` means its 16 x 16 production mesh; that mesh needs
256 ranks, which only the dry run's fake process group gives here
(``launch.dryrun``).  ``--device cpu`` runs the plain PyTorch versions on
the host; weights are random, drawn from ``--seed``, which also seeds the
data.
The synthetic batches carry tokens and labels only, as the reference's do,
so an encdec model (``--arch whisper-small``) fails for want of its frames,
as it does there (ROADMAP C5).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Sequence

import torch

from .. import _device
from .. import configs as config_registry
from ..checkpoint import CheckpointManager, latest_step
from ..core.controller import StopAndWaitController
from ..data import SyntheticLM
from ..models.config import ModelConfig
from ..optim import AdamWConfig
from ..runtime.comm_gate import CommGate, IterationReporter
from ..runtime.steps import build_train_step, init_train_state
from ..sharding import use_rules
from .mesh import make_host_mesh


@dataclasses.dataclass
class TrainResult:
    """What :func:`train` did: the step it started from (after a resume),
    each step's loss and wall time."""

    start: int
    losses: List[float]
    step_s: List[float]


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int, lr: float,
          n_micro: int = 1, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, log_every: int = 10, device: str = "cuda",
          seed: int = 0, job: str = "train",
          controller: Optional[StopAndWaitController] = None
          ) -> TrainResult:
    """Train ``cfg`` for ``steps`` steps of ``batch`` x ``seq`` synthetic
    tokens, resuming from ``ckpt_dir`` when it holds a checkpoint.  Each
    step waits on the TDM gate and reports its wall time to ``controller``
    (a fresh stop-and-wait controller when None)."""
    dev = _device.resolve(device)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=20, total_steps=steps)
    ds = SyntheticLM(cfg.vocab, seq, batch, seed=seed)
    controller = controller or StopAndWaitController()
    gate = CommGate(controller, job=job)
    reporter = IterationReporter(controller, job, priority=1)

    with use_rules(make_host_mesh(1, 1, device=dev)):
        return _train(cfg, opt_cfg, ds, gate, reporter, steps=steps,
                      n_micro=n_micro, ckpt_dir=ckpt_dir,
                      ckpt_every=ckpt_every, log_every=log_every, dev=dev,
                      seed=seed)


def _train(cfg, opt_cfg, ds, gate, reporter, *, steps, n_micro, ckpt_dir,
           ckpt_every, log_every, dev, seed) -> TrainResult:
    generator = torch.Generator(device=dev).manual_seed(seed)
    state = init_train_state(cfg, opt_cfg, generator, dev)
    step_fn = build_train_step(cfg, opt_cfg, n_micro)

    start = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep_n=3)
        if latest_step(ckpt_dir) is not None:
            state, start, _ = mgr.restore_latest(state)
            print(f"resumed from step {start}")

    out = TrainResult(start, [], [])
    t_last = time.perf_counter()
    for step in range(start, steps):
        batch_t = {k: torch.as_tensor(v, device=dev)
                   for k, v in ds.batch_at(step).items()}
        gate.wait_for_slot()  # Metronome TDM actuator (no-op standalone)
        state, metrics = step_fn(state, batch_t)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t_last
        t_last = time.perf_counter()
        reporter.report(dt)
        out.losses.append(loss)
        out.step_s.append(dt)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"{dt*1e3:.0f} ms/it", flush=True)
        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, state)
    if mgr is not None:
        mgr.save(steps, state)
        mgr.wait()
    return out


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--full", action="store_true",
                    help="full-size config on one card (1 x 1 mesh)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = (config_registry.get_config(args.arch) if args.full
           else config_registry.get_smoke_config(args.arch))
    train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
          n_micro=args.n_micro, ckpt_dir=args.ckpt_dir,
          ckpt_every=args.ckpt_every, log_every=args.log_every,
          device=args.device, seed=args.seed, job=f"train-{args.arch}")
    print("done")


if __name__ == "__main__":
    main()
