"""Evaluation of discovered units."""
