"""PyTorch and CUDA port of the VQ-CPC system, for NVIDIA Hopper cards.

Stands beside the JAX package ``vectorquantizedcpc_tpu``, which stays the
reference, and imports nothing of it. Entry points run on a CUDA card
unless the caller asks for the CPU (``runtime.platform=cpu``).
"""
