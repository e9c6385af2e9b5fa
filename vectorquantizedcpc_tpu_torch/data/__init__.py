"""Corpora, preprocessing, clip datasets and the batch loader."""
