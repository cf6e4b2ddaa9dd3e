"""Serving demo on the PyTorch port (``examples/serve_decode.py`` with
``repro_torch``): prefill a batch of prompts, then greedy-decode with the
KV cache / recurrent state through ``build_serve_step``.

Run:  PYTHONPATH=src python examples_torch/serve_decode.py --arch llama3-8b
      [--device cpu]
      (smoke-size config; same code path as the full config.  On the card,
      prefill runs the flash-attention kernel.)
"""
import argparse
import time

import torch

from repro_torch import _device
from repro_torch.configs import get_smoke_config
from repro_torch.models import init_model, prefill
from repro_torch.runtime import build_serve_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    dev = _device.resolve(args.device)  # raises where the card is missing
    gen = torch.Generator(device=dev.type).manual_seed(0)
    params = init_model(cfg, gen, dev)

    b, s = args.batch, args.prompt_len
    prompts = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                            device=gen.device).to(dev)

    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, prompts, max_len=s + args.gen)
    _sync(dev)
    print(f"prefill {b}x{s}: {(time.perf_counter()-t0)*1e3:.0f} ms")

    serve = build_serve_step(cfg)
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    out = [tok]
    t0 = time.perf_counter()
    with torch.inference_mode():
        for _ in range(args.gen - 1):
            logits, cache = serve(params, cache, tok)
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
            out.append(tok)
        _sync(dev)
    dt = time.perf_counter() - t0
    gen_tokens = torch.cat(out, dim=1).cpu()
    print(f"decoded {args.gen - 1} steps x batch {b}: "
          f"{dt / (args.gen - 1) * 1e3:.1f} ms/token/batch")
    print("sample token ids:", gen_tokens[0, :16].tolist())
    return gen_tokens


if __name__ == "__main__":
    main()
