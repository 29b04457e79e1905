"""Data substrate (counterpart of ``repro.data``)."""
from .pipeline import SyntheticLMData

__all__ = ["SyntheticLMData"]
