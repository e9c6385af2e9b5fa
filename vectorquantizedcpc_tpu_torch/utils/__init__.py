"""Profiling and observability helpers."""
