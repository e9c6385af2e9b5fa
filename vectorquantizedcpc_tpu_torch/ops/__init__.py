"""Kernels written for Hopper, each beside its plain PyTorch version."""
