"""Deterministic synthetic LM batches."""

from .pipeline import DataConfig, SyntheticLMStream, make_stream

__all__ = ["DataConfig", "SyntheticLMStream", "make_stream"]
