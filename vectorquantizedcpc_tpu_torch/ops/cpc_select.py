"""CPC negative scoring and selection: CUDA kernels, plain versions, autograd.

The port of the JAX package's ``ops/cpc_select.py`` (``cpc_negative_scores``
and its two Pallas kernels). For each prediction step k, speaker s, anchor
utterance u, negative n and anchor time l, all in f32::

    f_pos[k, s, u, l]    = wc[k, s, u, l] . z_shift[k, s, u, l]
    f_neg[k, s, u, n, l] = wc[k, s, u, l] . z_shift[k, s, v, m]
        with v = utt_index[k, u, n], m = seq_index[k, s, u, n, l]

``cpc_select`` and ``cpc_select_bwd`` launch the kernels of
``csrc/cpc_select.cu`` on CUDA tensors and run the plain versions on CPU
tensors. Every score, positive or negative, is one dot summed by the same
routine, so a negative drawn on the positive's own frame (or on an equal
vector: z is quantized) ties with it bit for bit, on both routes. Any L is
taken. ``CpcNegativeScores`` is the autograd Function (the custom VJP's
counterpart); the indices get no gradient. ``CPC_SELECT_LAUNCHES`` and
``CPC_SELECT_BWD_LAUNCHES`` count launches.
"""

from typing import Tuple

import torch

from ._build import on_card as _on_card

CPC_SELECT_LAUNCHES = 0
CPC_SELECT_BWD_LAUNCHES = 0
MAX_Z = 256  # kZLane * 32 in csrc/cpc_select.cu


def check_select_inputs(wc, zs, utt_index, seq_index, kernel: bool = False) -> None:
    """Raise ``ValueError`` on what the kernels do not take: wc and z_shift
    (K, S, U, L, Z) f32, utt_index (K, U, N) and seq_index (K, S, U, N, L)
    int32, all contiguous on one device; for the kernel Z <= 256."""
    if wc.dim() != 5:
        raise ValueError(f"wc must be (K, S, U, L, Z); got {tuple(wc.shape)}")
    k, s, u, l, z = wc.shape
    n = utt_index.shape[-1] if utt_index.dim() == 3 else -1
    expect = {
        "wc": (wc, torch.float32, (k, s, u, l, z)),
        "z_shift": (zs, torch.float32, (k, s, u, l, z)),
        "utt_index": (utt_index, torch.int32, (k, u, n)),
        "seq_index": (seq_index, torch.int32, (k, s, u, n, l)),
    }
    for name, (x, dtype, shape) in expect.items():
        if x.device != wc.device:
            raise ValueError(f"{name} is on {x.device}, wc on {wc.device}")
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got {x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if min(k, s, u, l, z, n) < 1:
        raise ValueError(f"empty CPC selection: wc {tuple(wc.shape)}, N = {n}")
    if kernel and z > MAX_Z:
        raise ValueError(f"Z={z}: the kernel takes Z <= {MAX_Z}")


def _flat_index(utt_index: torch.Tensor, seq_index: torch.Tensor) -> torch.Tensor:
    """Row v L + m of each (k, s) tile for the positive (n = 0: v = u, m = l)
    and the N negatives: (K, S, U, 1 + N, L) int64."""
    k, s, u, n, l = seq_index.shape
    neg = utt_index.long()[:, None, :, :, None] * l + seq_index.long()
    pos = (torch.arange(u, device=neg.device)[:, None] * l
           + torch.arange(l, device=neg.device)).expand(k, s, u, l)
    return torch.cat([pos[:, :, :, None], neg], dim=3)


def _candidates(zs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """z_shift rows at ``idx``: (K, S, U, 1 + N, L, Z)."""
    k, s = zs.shape[:2]
    flat = zs.reshape(k, s, -1, zs.shape[-1])
    kk = torch.arange(k, device=zs.device)[:, None, None, None, None]
    ss = torch.arange(s, device=zs.device)[None, :, None, None, None]
    return flat[kk, ss, idx]


@torch.no_grad()
def cpc_select_reference(wc, zs, utt_index, seq_index) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (f_neg (K, S, U, N, L), f_pos (K, S, U, L))."""
    cand = _candidates(zs, _flat_index(utt_index, seq_index))
    f = (cand * wc[:, :, :, None]).sum(-1)  # one reduction for positive and negatives
    return f[:, :, :, 1:].contiguous(), f[:, :, :, 0].contiguous()


@torch.no_grad()
def cpc_select_bwd_reference(d_fneg, d_fpos, wc, zs, utt_index, seq_index):
    """Plain version of the backward kernel: (d_wc, d_zs), both (K, S, U, L, Z) f32."""
    k, s, u, l, z = wc.shape
    idx = _flat_index(utt_index, seq_index)
    d_f = torch.cat([d_fpos[:, :, :, None], d_fneg], dim=3)  # (K, S, U, 1 + N, L)
    d_wc = (d_f[..., None] * _candidates(zs, idx)).sum(3)
    contrib = d_f[..., None] * wc[:, :, :, None]  # (K, S, U, 1 + N, L, Z)
    base = torch.arange(k * s, device=wc.device).reshape(k, s, 1, 1, 1) * (u * l)
    d_zs = torch.zeros(k * s * u * l, z, dtype=torch.float32, device=wc.device)
    d_zs.index_add_(0, (idx + base).reshape(-1), contrib.reshape(-1, z))
    return d_wc, d_zs.reshape(k, s, u, l, z)


def cpc_select(wc, zs, utt_index, seq_index) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f_neg (K, S, U, N, L), f_pos (K, S, U, L)) f32. On a CUDA tensor this
    launches the kernel on the current stream without waiting for it."""
    global CPC_SELECT_LAUNCHES
    on_card = _on_card(wc, "cpc_select")
    check_select_inputs(wc, zs, utt_index, seq_index, kernel=on_card)
    if not on_card:
        return cpc_select_reference(wc, zs, utt_index, seq_index)
    from . import _build

    k, s, u, l, z = wc.shape
    n = utt_index.shape[-1]
    f_neg = torch.empty(k, s, u, n, l, dtype=torch.float32, device=wc.device)
    f_pos = torch.empty(k, s, u, l, dtype=torch.float32, device=wc.device)
    with torch.cuda.device(wc.device):
        err = _build.library().vq_cpc_select_launch(
            *[x.data_ptr() for x in (wc, zs, utt_index, seq_index, f_neg, f_pos)],
            k * s, s, u, n, l, z, torch.cuda.current_stream(wc.device).cuda_stream,
        )
    _build.check(err, "cpc_select kernel launch")
    CPC_SELECT_LAUNCHES += 1
    return f_neg, f_pos


def cpc_select_bwd(d_fneg, d_fpos, wc, zs, utt_index, seq_index):
    """(d_wc, d_zs), both (K, S, U, L, Z) f32. d_zs sums with atomics on the
    card, in an order that varies from run to run (f32 rounding only)."""
    global CPC_SELECT_BWD_LAUNCHES
    on_card = _on_card(wc, "cpc_select_bwd")
    check_select_inputs(wc, zs, utt_index, seq_index, kernel=on_card)
    k, s, u, l, z = wc.shape
    n = utt_index.shape[-1]
    for name, x, shape in (("d_fneg", d_fneg, (k, s, u, n, l)), ("d_fpos", d_fpos, (k, s, u, l))):
        if x.device != wc.device or x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected float32 {shape} on {wc.device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not on_card:
        return cpc_select_bwd_reference(d_fneg, d_fpos, wc, zs, utt_index, seq_index)
    from . import _build

    lib = _build.library()
    d_wc = torch.empty_like(wc)
    # The kernel adds into the output itself when its tile does not fit.
    tiled = lib.vq_cpc_select_uses_tile(u, l, z)
    d_zs = torch.empty_like(zs) if tiled else torch.zeros_like(zs)
    with torch.cuda.device(wc.device):
        err = lib.vq_cpc_select_bwd_launch(
            *[x.data_ptr() for x in (d_fneg, d_fpos, wc, zs, utt_index, seq_index, d_wc, d_zs)],
            k * s, s, u, n, l, z, torch.cuda.current_stream(wc.device).cuda_stream,
        )
    _build.check(err, "cpc_select_bwd kernel launch")
    CPC_SELECT_BWD_LAUNCHES += 1
    return d_wc, d_zs


class CpcNegativeScores(torch.autograd.Function):
    """(wc, z_shift, utt_index, seq_index) -> (f_neg, f_pos), backward by
    ``cpc_select_bwd``; a missing cotangent counts as zeros."""

    @staticmethod
    def forward(ctx, wc, zs, utt_index, seq_index):
        ctx.save_for_backward(wc, zs, utt_index, seq_index)
        return cpc_select(wc, zs, utt_index, seq_index)

    @staticmethod
    def backward(ctx, d_fneg, d_fpos):
        wc, zs, utt_index, seq_index = ctx.saved_tensors
        k, s, u, l, _ = wc.shape
        n = utt_index.shape[-1]
        if d_fneg is None:
            d_fneg = wc.new_zeros(k, s, u, n, l)
        if d_fpos is None:
            d_fpos = wc.new_zeros(k, s, u, l)
        d_wc, d_zs = cpc_select_bwd(d_fneg.float().contiguous(), d_fpos.float().contiguous(),
                                    wc, zs, utt_index, seq_index)
        return d_wc, d_zs, None, None


def cpc_negative_scores(wc, z_shift, utt_index, seq_index) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable scores: (f_neg (K, S, U, N, L), f_pos (K, S, U, L)) f32."""
    return CpcNegativeScores.apply(
        wc.float().contiguous(), z_shift.float().contiguous(),
        utt_index.to(torch.int32).contiguous(), seq_index.to(torch.int32).contiguous(),
    )
