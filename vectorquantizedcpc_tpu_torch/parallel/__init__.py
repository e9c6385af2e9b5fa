"""Data parallelism for the trainers: ranks, their cards and their collectives."""
