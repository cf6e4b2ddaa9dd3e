from .config import SHAPES, ModelConfig, ShapeConfig
from .convert import params_from_jax
from .model import (COUNTERS, abstract_params, cache_logical, decode_step,
                    forward, init_cache, init_model, join_counters,
                    logical_specs, loss_fn, param_count, prefill)

__all__ = ["COUNTERS", "SHAPES", "ModelConfig", "ShapeConfig",
           "abstract_params", "cache_logical", "decode_step", "forward",
           "init_cache", "init_model", "join_counters", "logical_specs",
           "loss_fn", "param_count", "params_from_jax", "prefill"]
