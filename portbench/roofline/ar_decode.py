"""The AR decode kernel: one launch decodes ``steps`` samples of ``batch`` rows.

Per sample and row: the GRU's recurrent product (H x 3H), FC1 (H x F) and
FC2 (F x C) in bf16 with f32 sums; the input projection comes from a
pre-projected table (gathered) and the frame-rate conditioning rows. Read
once: the bf16 weights (table C x 3H, wh H x 3H, FC1 H x F, FC2 F x C),
the f32 biases, the conditioning (frames x batch x 3H bf16), h0 (f32) and
the previous class (int32). Written once: the classes (int32) and h_T (f32).
"""

from .peaks import least_seconds

KERNELS = ("ar_decode_kernel",)
LAUNCHES_PER_CALL = 1


def flops(batch, steps, hidden, fc, classes, **_):
    return 2.0 * batch * steps * (hidden * 3 * hidden + hidden * fc + fc * classes)


def n_bytes(batch, steps, hidden, fc, classes, frames, **_):
    weights = 2 * (classes * 3 * hidden + hidden * 3 * hidden + hidden * fc + fc * classes)
    biases = 4 * (3 * hidden + fc + classes)
    inputs = 2 * frames * batch * 3 * hidden + 4 * batch * hidden + 4 * batch
    outputs = 4 * steps * batch + 4 * batch * hidden
    return float(weights + biases + inputs + outputs)


def least(call: dict) -> float:
    return least_seconds(flops(**call), n_bytes(**call))
