"""Optimizer of the port: AdamW and gradient compression (the JAX
package's ``optim``)."""
from .adamw import (AdamWConfig, adamw_init, adamw_update, cosine_schedule,
                    global_norm)
from .compression import (compress_ef_int8, decompress_ef_int8,
                          make_ef_state, quantize_int8)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "compress_ef_int8", "decompress_ef_int8", "global_norm",
           "make_ef_state", "quantize_int8"]
