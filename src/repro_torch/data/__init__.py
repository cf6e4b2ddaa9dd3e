from .pipeline import SyntheticLM, packed_batch_iterator

__all__ = ["SyntheticLM", "packed_batch_iterator"]
