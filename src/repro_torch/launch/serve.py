"""Serving entry point: batched greedy decoding with Metronome reporting.

``python -m repro_torch.launch.serve --arch llama3-8b --full``

The port's counterpart of ``repro.launch.serve``: a request queue is
admitted ``--batch`` at a time, each batch is prefilled once and then
decoded step by step with the KV cache / recurrent state; every decode
step's wall time goes to the stop-and-wait controller, the same way
training steps do (serving jobs are periodic-traffic jobs too).  Without
``--full`` it takes the architecture's smoke config, with it the
full-size one, on one card under the sharding rules of a 1 x 1 host mesh
(on one rank nothing is split; the reference's ``--full`` means its
256-rank production mesh, which only the dry run's fake process group
gives here).
``--device cpu`` runs the plain PyTorch versions on the host.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Sequence

import torch

from .. import _device
from .. import configs as config_registry
from ..core.controller import StopAndWaitController
from ..models import init_model, prefill
from ..models.config import ModelConfig
from ..runtime.comm_gate import IterationReporter
from ..runtime.steps import build_serve_step
from ..sharding import use_rules
from .mesh import make_host_mesh


@dataclasses.dataclass
class ServeResult:
    """What :func:`serve_requests` did: per batch the greedy tokens (B, gen)
    on the host, prefill's last-position logits (B, 1, V) on the device and
    the prefill wall time; every decode step's wall time; whether every
    logit was finite."""

    tokens: List[torch.Tensor]
    prefill_logits: List[torch.Tensor]
    prefill_s: List[float]
    step_s: List[float]
    finite: bool


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_prompts(cfg: ModelConfig, requests: int, batch: int,
                 prompt_len: int, generator: torch.Generator,
                 device: torch.device) -> List[torch.Tensor]:
    """The request queue: ``requests`` random prompts of ``prompt_len``
    tokens drawn from ``generator``, cut into batches of ``batch``."""
    tokens = torch.randint(0, cfg.vocab, (requests, prompt_len),
                           generator=generator, device=generator.device)
    return list(tokens.to(device).split(batch))


def make_frames(cfg: ModelConfig, requests: int, batch: int,
                prompt_len: int, generator: torch.Generator,
                device: torch.device) -> Optional[List[torch.Tensor]]:
    """An encdec model's stub frame embeddings, (B, prompt_len //
    enc_frames_ratio, d_model) float32 a batch of ``batch``, drawn from
    ``generator`` (None for the other families), as the JAX package's
    serving driver gives them."""
    if cfg.family != "encdec":
        return None
    n = max(prompt_len // cfg.enc_frames_ratio, 1)
    frames = torch.randn((requests, n, cfg.d_model), generator=generator,
                         device=generator.device)
    return list(frames.to(device).split(batch))


def serve_requests(params, cfg: ModelConfig, prompts: Sequence[torch.Tensor],
                   gen: int, reporter: IterationReporter,
                   frames: Optional[Sequence[torch.Tensor]] = None
                   ) -> ServeResult:
    """Serve each (B, S) prompt batch in turn: one ``prefill`` with room for
    ``gen`` tokens, then ``gen - 1`` greedy decode steps, each step's wall
    time (to the end of its device work) reported to ``reporter``.
    ``frames``: an encdec model's frame embeddings, one tensor a batch."""
    serve = build_serve_step(cfg)
    out = ServeResult([], [], [], [], True)
    with torch.inference_mode():
        finite = None
        for i, batch in enumerate(prompts):
            dev = batch.device
            t0 = time.perf_counter()
            logits, cache = prefill(
                params, cfg, batch, max_len=batch.shape[1] + gen,
                frames=None if frames is None else frames[i])
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
            finite = torch.isfinite(logits).all() if finite is None \
                else finite & torch.isfinite(logits).all()
            _sync(dev)
            out.prefill_s.append(time.perf_counter() - t0)
            out.prefill_logits.append(logits)
            toks = [tok]
            for _ in range(gen - 1):
                t0 = time.perf_counter()
                logits, cache = serve(params, cache, tok)
                tok = logits[:, -1].argmax(dim=-1, keepdim=True)
                finite &= torch.isfinite(logits).all()
                _sync(dev)
                dt = time.perf_counter() - t0
                reporter.report(dt)
                out.step_s.append(dt)
                toks.append(tok)
            out.tokens.append(torch.cat(toks, dim=1).cpu())
        out.finite = finite is None or bool(finite)
    return out


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = (config_registry.get_config(args.arch) if args.full
           else config_registry.get_smoke_config(args.arch))
    dev = _device.resolve(args.device)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    controller = StopAndWaitController()
    reporter = IterationReporter(controller, f"serve-{args.arch}", priority=1)

    with use_rules(make_host_mesh(1, 1, device=dev)):
        params = init_model(cfg, generator, dev)
        prompts = make_prompts(cfg, args.requests, args.batch,
                               args.prompt_len, generator, dev)
        frames = make_frames(cfg, args.requests, args.batch,
                             args.prompt_len, generator, dev)
        t_start = time.perf_counter()
        res = serve_requests(params, cfg, prompts, args.gen, reporter,
                             frames)
        dt = time.perf_counter() - t_start
    done = 0
    for toks in res.tokens:
        done += toks.shape[0]
        print(f"batch of {toks.shape[0]} done ({done}/{args.requests})")
    n_tok = sum(t.numel() for t in res.tokens)
    print(f"served {args.requests} requests, {n_tok} tokens in {dt:.1f}s "
          f"({n_tok / dt:.1f} tok/s)")


if __name__ == "__main__":
    main()
