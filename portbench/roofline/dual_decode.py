"""The dual softmax decode kernel: one launch decodes ``steps`` 16-bit samples of ``batch`` rows.

Per sample and row: the GRU's recurrent product (H x 3H, both halves), the
coarse head (H/2 x H/2, then H/2 x C) and the fine head (the same), in
bf16 with f32 sums; the byte inputs' columns and c_t's are scalar products
(left out, as element-wise work). Read once: the bf16 weights (wh, the
four head matrices), the f32 vectors (bh, the two byte columns of the
input matrix, c_t's column, the heads' biases), the conditioning (frames x
batch x 3H bf16), h0 (f32) and the two bytes before (int32). Written once:
the samples (int32) and h_T (f32).
"""

from .peaks import least_seconds

KERNELS = ("dual_decode_kernel",)
LAUNCHES_PER_CALL = 1


def _weights(hidden, classes):
    half = hidden // 2
    return hidden * 3 * hidden + 2 * (half * half + half * classes)


def flops(batch, steps, hidden, classes, **_):
    return 2.0 * batch * steps * _weights(hidden, classes)


def n_bytes(batch, steps, hidden, classes, frames, **_):
    half = hidden // 2
    vectors = 4 * (3 * hidden + 2 * 3 * hidden + 3 * half + 2 * half + 2 * classes)
    inputs = 2 * frames * batch * 3 * hidden + 4 * batch * hidden + 2 * 4 * batch
    outputs = 4 * steps * batch + 4 * batch * hidden
    return float(2 * _weights(hidden, classes) + vectors + inputs + outputs)


def least(call: dict) -> float:
    return least_seconds(flops(**call), n_bytes(**call))
