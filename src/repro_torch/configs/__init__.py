"""Configurations of the port: the Metronome testbed, and the model
architectures the port serves so far (one module per architecture)."""
from __future__ import annotations

import importlib
from typing import Dict, List

# the JAX package's other architectures wait for their model families
# (ROADMAP A13b: moe, xlstm, encdec)
ARCHS: List[str] = [
    "internlm2_20b",
    "qwen3_14b",
    "llama3_8b",
    "starcoder2_15b",
    "qwen2_vl_72b",
    "recurrentgemma_2b",
]

_ALIAS: Dict[str, str] = {a.replace("_", "-"): a for a in ARCHS}
_ALIAS.update({a: a for a in ARCHS})
# assignment ids use dashes/dots
_ALIAS.update({
    "internlm2-20b": "internlm2_20b",
    "qwen3-14b": "qwen3_14b",
    "llama3-8b": "llama3_8b",
    "starcoder2-15b": "starcoder2_15b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "recurrentgemma-2b": "recurrentgemma_2b",
})


def canonical(arch: str) -> str:
    """The module name of an architecture id (dashes or underscores)."""
    try:
        return _ALIAS[arch]
    except KeyError:
        raise KeyError(f"architecture {arch!r} is not ported yet; the port "
                       f"has {ARCHS} (ROADMAP A13b)") from None


def get_config(arch: str):
    """Load the full-size ModelConfig for an architecture id."""
    return importlib.import_module(
        f"repro_torch.configs.{canonical(arch)}").config()


def get_smoke_config(arch: str):
    """Reduced same-family config for CPU smoke tests."""
    return importlib.import_module(
        f"repro_torch.configs.{canonical(arch)}").smoke_config()
