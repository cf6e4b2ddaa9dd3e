"""Check modules; importing the package registers every check."""
from . import (cache_keys, determinism, epoch, kernel_parity,  # noqa: F401
               shared_state)
