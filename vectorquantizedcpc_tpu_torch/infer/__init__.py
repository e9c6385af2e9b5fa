"""Inference entry points."""

from .serving import ContinuousBatcher

__all__ = ["ContinuousBatcher"]
