"""The vocoder's GRU grid pair in training: forward with residuals, backward.

Forward, per row and step, the recurrent product (H x 3H). Read: wh (H x
3H bf16), bh (3H f32), xproj (T x B x 3H bf16), h0 (B x H f32); written:
hs (T x B x H bf16), acts (T x B x 3H bf16), hns (T x B x H bf16), h_T (B
x H f32). Backward, per row and step, the gate gradient's product with
wh^T (3H x H). Read: acts, hns, h_prevs and dhs (bf16), wh, dh_T (f32);
written: dgx and dgh (T x B x 3H bf16), dh0 (B x H f32).
"""

from .peaks import least_seconds

KERNELS = ("gru_scan_grid_kernel", "gru_scan_bwd_kernel")
LAUNCHES_PER_CALL = 2


def _fwd(T, B, H):
    f = 2.0 * T * B * H * 3 * H
    b = 2 * H * 3 * H + 4 * 3 * H + 2 * T * B * 3 * H + 4 * B * H
    b += 2 * T * B * H + 2 * T * B * 3 * H + 2 * T * B * H + 4 * B * H
    return f, b


def _bwd(T, B, H):
    f = 2.0 * T * B * H * 3 * H
    b = 2 * T * B * 3 * H + 3 * 2 * T * B * H + 2 * H * 3 * H + 4 * B * H
    b += 2 * 2 * T * B * 3 * H + 4 * B * H
    return f, b


def flops(T, B, H, **_):
    return _fwd(T, B, H)[0] + _bwd(T, B, H)[0]


def n_bytes(T, B, H, **_):
    return float(_fwd(T, B, H)[1] + _bwd(T, B, H)[1])


def least(call: dict) -> float:
    return least_seconds(*_fwd(call["T"], call["B"], call["H"])) + least_seconds(
        *_bwd(call["T"], call["B"], call["H"]))
