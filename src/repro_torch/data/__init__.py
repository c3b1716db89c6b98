"""Data pipeline: a copy of the reference's ``repro/data``."""

from .pipeline import SyntheticLM, make_batches

__all__ = ["SyntheticLM", "make_batches"]
