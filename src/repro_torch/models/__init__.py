from .config import SHAPES, ModelConfig, ShapeConfig
from .convert import params_from_jax
from .model import (decode_step, forward, init_cache, init_model, loss_fn,
                    param_count, prefill)

__all__ = ["SHAPES", "ModelConfig", "ShapeConfig", "decode_step", "forward",
           "init_cache", "init_model", "loss_fn", "param_count",
           "params_from_jax", "prefill"]
