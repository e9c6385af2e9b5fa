"""The benchmark's plain float32 reference of both models.

Written from the published description (tarepan/VectorQuantizedCPC: the
encoder and CPC loss of ``model.py``, the RNN_MS vocoder, the reference
training loops' Adam), in plain ``torch`` on float32 tensors with TF32
off. It imports nothing of the program under test and nothing of the JAX
package: it reads the harness's own weights (the state dicts the harness
drew from the seed) and the inputs the harness made, and judges what the
program returned.
"""

import torch


def strict_float32() -> None:
    """Products in full float32: no TF32 and no reduced-precision sums."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.set_float32_matmul_precision("highest")
