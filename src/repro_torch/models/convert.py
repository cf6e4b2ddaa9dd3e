"""Carry the JAX package's model parameters over to the port.

``params_from_jax`` takes the nested dict that ``repro.models.init_model``
returns, with every leaf given as a numpy array (bfloat16 leaves converted
to float32 first), and returns the port's parameters: the same tree, each
leaf a tensor in ``cfg.param_dtype`` on ``device``.  The tests use it to run
both packages on the same weights.  This module imports no JAX.
"""
from __future__ import annotations

from typing import Mapping, Union

import numpy as np
import torch

from .. import _device
from .config import ModelConfig
from .model import Tree

# leaves the JAX init keeps in float32 whatever the parameter dtype
_FLOAT32_LEAVES = frozenset({"lam", "router"})


def params_from_jax(tree: Mapping, cfg: ModelConfig,
                    device: Union[str, torch.device] = "cuda") -> Tree:
    dev = _device.resolve(device)

    def convert(node: Mapping) -> Tree:
        out: Tree = {}
        for key, leaf in node.items():
            if isinstance(leaf, Mapping):
                out[key] = convert(leaf)
                continue
            dtype = (torch.float32 if key in _FLOAT32_LEAVES
                     else cfg.param_dtype)
            arr = np.array(leaf, dtype=np.float32)  # a writable copy
            out[key] = torch.from_numpy(arr).to(device=dev, dtype=dtype)
        return out

    return convert(tree)
