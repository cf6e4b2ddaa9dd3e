"""Configurations of the port: the Metronome testbed, and the model
architectures the port serves so far (one module per architecture)."""
from __future__ import annotations

import importlib
from typing import Dict, List

# the JAX package's other architectures wait for their model families
# (ROADMAP A13: dense, moe, xlstm, encdec)
ARCHS: List[str] = ["recurrentgemma_2b"]

_ALIAS: Dict[str, str] = {a.replace("_", "-"): a for a in ARCHS}
_ALIAS.update({a: a for a in ARCHS})


def canonical(arch: str) -> str:
    """The module name of an architecture id (dashes or underscores)."""
    try:
        return _ALIAS[arch]
    except KeyError:
        raise KeyError(f"architecture {arch!r} is not ported yet; the port "
                       f"has {ARCHS} (ROADMAP A13)") from None


def get_config(arch: str):
    """Load the full-size ModelConfig for an architecture id."""
    return importlib.import_module(
        f"repro_torch.configs.{canonical(arch)}").config()


def get_smoke_config(arch: str):
    """Reduced same-family config for CPU smoke tests."""
    return importlib.import_module(
        f"repro_torch.configs.{canonical(arch)}").smoke_config()
