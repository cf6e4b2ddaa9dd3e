"""Configurations of the port: the Metronome testbed, and the model
architectures (one module per architecture, as the JAX package's)."""
from __future__ import annotations

import importlib
from typing import Dict, List

ARCHS: List[str] = [
    "arctic_480b",
    "qwen2_moe_a2_7b",
    "internlm2_20b",
    "qwen3_14b",
    "llama3_8b",
    "starcoder2_15b",
    "qwen2_vl_72b",
    "whisper_small",
    "recurrentgemma_2b",
    "xlstm_125m",
]

# the port's own architectures, which the JAX package does not have
PORT_ARCHS: List[str] = [
    "mellum2_12b_a2_5b",
]

_ALIAS: Dict[str, str] = {a.replace("_", "-"): a
                          for a in ARCHS + PORT_ARCHS}
_ALIAS.update({a: a for a in ARCHS + PORT_ARCHS})
# assignment ids use dashes/dots
_ALIAS.update({
    "arctic-480b": "arctic_480b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "internlm2-20b": "internlm2_20b",
    "qwen3-14b": "qwen3_14b",
    "llama3-8b": "llama3_8b",
    "starcoder2-15b": "starcoder2_15b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "whisper-small": "whisper_small",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "xlstm-125m": "xlstm_125m",
    "mellum2-12b-a2.5b": "mellum2_12b_a2_5b",
})


def canonical(arch: str) -> str:
    """The module name of an architecture id (dashes or underscores);
    ``KeyError`` for an unknown one, as the JAX package's registry."""
    return _ALIAS[arch]


def get_config(arch: str):
    """Load the full-size ModelConfig for an architecture id."""
    return importlib.import_module(
        f"repro_torch.configs.{canonical(arch)}").config()


def get_smoke_config(arch: str):
    """Reduced same-family config for CPU smoke tests."""
    return importlib.import_module(
        f"repro_torch.configs.{canonical(arch)}").smoke_config()
