"""The context LSTM's cluster pair in training: forward with residuals, backward.

Forward, per row and step, the recurrent product (H x 4H). Read: wh (H x
4H bf16), xproj (T x B x 4H bf16), h0 and c0 (B x H f32); written: hs (T x
B x H bf16), acts (T x B x 4H bf16), c_prev (T x B x H f32), h_T and c_T
(B x H f32). Backward, per row and step, the gate gradient's product with
wh^T. Read: acts (bf16), c_prev (f32), dhs (bf16), wh, dh_T and dc_T
(f32); written: dgates (T x B x 4H bf16), dh0 and dc0 (B x H f32).
"""

from .peaks import least_seconds

KERNELS = ("lstm_scan_kernel", "lstm_scan_bwd_kernel")
LAUNCHES_PER_CALL = 2


def _fwd(T, B, H):
    f = 2.0 * T * B * H * 4 * H
    b = 2 * H * 4 * H + 2 * T * B * 4 * H + 2 * 4 * B * H
    b += 2 * T * B * H + 2 * T * B * 4 * H + 4 * T * B * H + 2 * 4 * B * H
    return f, b


def _bwd(T, B, H):
    f = 2.0 * T * B * H * 4 * H
    b = 2 * T * B * 4 * H + 4 * T * B * H + 2 * T * B * H + 2 * H * 4 * H + 2 * 4 * B * H
    b += 2 * T * B * 4 * H + 2 * 4 * B * H
    return f, b


def flops(T, B, H, **_):
    return _fwd(T, B, H)[0] + _bwd(T, B, H)[0]


def n_bytes(T, B, H, **_):
    return float(_fwd(T, B, H)[1] + _bwd(T, B, H)[1])


def least(call: dict) -> float:
    return least_seconds(*_fwd(call["T"], call["B"], call["H"])) + least_seconds(
        *_bwd(call["T"], call["B"], call["H"]))
