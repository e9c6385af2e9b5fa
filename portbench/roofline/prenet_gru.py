"""The serving PreNet's GRU scans: one layer direction over a padded batch.

A call is the forward scan and the masked reverse scan of one layer over
G rows of T frames at hidden H (both bf16 products with f32 sums). Per
row and step: the recurrent product (H x 3H). The forward scan runs every
step; the masked scan only the valid ones (``valid`` steps in all). Read
once each: xproj (T x G x 3H bf16), wh (H x 3H bf16), bh (3H f32), h0 (G
x H f32), and the mask (T x G int32) for the masked scan. Written: hs (T
x G x H bf16) and h_T (G x H f32) each.
"""

from .peaks import least_seconds

KERNELS = ("gru_scan_kernel",)
LAUNCHES_PER_CALL = 2


def _scan(t, g, h, steps, masked):
    f = 2.0 * steps * h * 3 * h
    b = 2 * t * g * 3 * h + 2 * h * 3 * h + 4 * 3 * h + 4 * g * h + 2 * t * g * h + 4 * g * h
    return f, b + (4 * t * g if masked else 0)


def flops(T, G, H, valid, **_):
    return _scan(T, G, H, T * G, False)[0] + _scan(T, G, H, valid, True)[0]


def n_bytes(T, G, H, valid, **_):
    return float(_scan(T, G, H, T * G, False)[1] + _scan(T, G, H, valid, True)[1])


def least(call: dict) -> float:
    fwd = least_seconds(*_scan(call["T"], call["G"], call["H"], call["T"] * call["G"], False))
    rev = least_seconds(*_scan(call["T"], call["G"], call["H"], call["valid"], True))
    return fwd + rev
