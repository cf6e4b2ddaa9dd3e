from .pipeline import SyntheticLM, make_batch_specs, packed_batch_iterator

__all__ = ["SyntheticLM", "make_batch_specs", "packed_batch_iterator"]
