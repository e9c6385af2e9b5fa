"""CPC negative scoring and selection: forward and backward, float32.

Forward: for each (k, s, u, l) the positive and N negatives, each a dot
of Z (2 Z operations). Read: wc and z_shift (K x S x U x L x Z f32),
utt_index (K x U x N int32), seq_index (K x S x U x N x L int32); written:
f_neg (K x S x U x N x L f32), f_pos (K x S x U x L f32). Backward: each
score's cotangent scaled into both operands (twice the forward's
operations). Read: both cotangents, wc, z_shift and the indices; written:
d_wc and d_zs (K x S x U x L x Z f32). No tensor core takes these dots:
they are held to the float32 peak.
"""

from .peaks import F32_FLOPS, least_seconds

KERNELS = ("select_fwd_kernel", "select_bwd_kernel")
LAUNCHES_PER_CALL = 2


def _sizes(K, S, U, N, L, Z):
    rows = K * S * U * L
    return rows, 4 * rows * Z, 4 * K * U * N + 4 * rows * N, 4 * rows * (N + 1)


def _fwd(K, S, U, N, L, Z):
    rows, wz, idx, scores = _sizes(K, S, U, N, L, Z)
    return 2.0 * rows * (N + 1) * Z, 2 * wz + idx + scores


def _bwd(K, S, U, N, L, Z):
    rows, wz, idx, scores = _sizes(K, S, U, N, L, Z)
    return 4.0 * rows * (N + 1) * Z, scores + 2 * wz + idx + 2 * wz


def flops(K, S, U, N, L, Z, **_):
    return _fwd(K, S, U, N, L, Z)[0] + _bwd(K, S, U, N, L, Z)[0]


def n_bytes(K, S, U, N, L, Z, **_):
    return float(_fwd(K, S, U, N, L, Z)[1] + _bwd(K, S, U, N, L, Z)[1])


def least(call: dict) -> float:
    dims = [call[k] for k in ("K", "S", "U", "N", "L", "Z")]
    return least_seconds(*_fwd(*dims), F32_FLOPS) + least_seconds(*_bwd(*dims), F32_FLOPS)
