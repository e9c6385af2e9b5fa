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
vector: z is quantized) ties with it bit for bit, on both routes. The
backward gives each row of d_wc and d_zs one writer that sums its sources
in a fixed order (d_zs: ascending (u, n, l), the positive before its own
utterance's negatives, as the plain version's ``index_add_``), so both are
the same bits on every launch. Any K, S, U, N, L and Z are taken.
``CpcNegativeScores`` is the autograd Function (the custom VJP's
counterpart); the indices get no gradient. ``CPC_SELECT_LAUNCHES`` and
``CPC_SELECT_BWD_LAUNCHES`` count launches. ``select_plan`` mirrors the
kernels' launch plan; the
stamped variants (``cpc_select_stamped``, ``cpc_select_bwd_stamped``) time
each phase for ``summarize_select_stamps``; no entry point calls them.
"""

from typing import Dict, Tuple

import torch

from ._build import expect_tensors
from ._build import on_card as _on_card

CPC_SELECT_LAUNCHES = 0
CPC_SELECT_BWD_LAUNCHES = 0
# The stamped kernels (measurement only: no entry point calls them).
CPC_SELECT_STAMPED_LAUNCHES = 0
CPC_SELECT_BWD_STAMPED_LAUNCHES = 0
# The phases the stamped kernels time, in csrc/cpc_select.cu's Phase and
# BwdPhase order.
FWD_STAMP_PHASES = ("tile load", "row and index loads", "dots", "stores")
BWD_STAMP_PHASES = ("list pairs", "list masks", "list counts", "list places", "tile load",
                    "row and list loads", "sums", "stores")

# csrc/cpc_select.cu's Plan, field by field (vq_cpc_select_plan's order).
PLAN_FIELDS = ("pieces", "threads", "parts", "wc_blocks", "zp", "fwd_tile", "fwd_smem",
               "bwd_tile", "bwd_lists", "scratch", "room", "bwd_smem", "zs_parts")
_BAR = 16  # shared-memory bytes of a block's staging mbarrier


def select_plan(k: int, s: int, u: int, n: int, l: int, z: int, sms: int,
                smem: int) -> Dict[str, int]:
    """The kernels' launch plan (``csrc/cpc_select.cu:make_plan``) on a card
    of ``sms`` SMs and ``smem`` bytes of shared memory per block: 16-byte
    pieces per lane per pass over Z and the block size; the forward's
    blocks per (k, s) (as many as fill the SMs once, no more than the rows
    take rounds of the block's groups of 8 lanes, and enough that each
    lists its anchors' candidate rows in shared memory); the backward's d_zs
    blocks per (k, s) (2 where 2.5 blocks per (k, s) fit the SMs and the
    lists fit shared memory, else 1) and its d_wc blocks (the SMs left, or
    max(KS, SMs - KS), each a range of the K S U L rows); the staged row stride;
    whether the forward stages the (k, s) tile, and its bytes (the tile,
    then the candidate lists); whether
    the backward stages its tile and builds the d_zs lists in shared
    memory (their bit masks and places, ``scratch`` bytes, in the tile's
    room; the entries after it; the index lists last), and its bytes."""
    pieces = 2 if z <= 64 else (4 if z <= 128 else 8)
    threads = 1024 if pieces == 2 else 512
    ul, unl, ks = u * l, u * n * l, k * s
    rounds = -(-ul // (threads // 8))
    per_anchor = 4 * (n + 1)
    parts = max(1, min(sms // ks, rounds), -(-ul // ((smem - _BAR - 16) // per_anchor)))
    zp = -(-z // 4) * 4
    tile, entries = ul * zp * 4, ul * (n + 1) * 8
    idx = -(-(-(-ul // parts) * per_anchor) // 16) * 16
    fwd_tile = _BAR + tile + idx <= smem
    small = -(-4 * (2 * ul + 3 * u * n + 2 * u + 1) // 16) * 16
    un = u * n
    scratch = -(-(4 * l * (((un * -(-l // 32)) | 1) + (un | 1)) + ul * 4) // 16) * 16
    bwd_limit = smem - 4 * 32  # the backward's static shared words (block_scan)
    bwd_tile = _BAR + tile + small <= bwd_limit
    tile_room = tile if bwd_tile else 0
    bwd_lists = _BAR + max(tile_room, scratch) + entries + small <= bwd_limit
    room = max(tile_room, scratch) if bwd_lists else tile_room
    zs_parts = 2 if bwd_lists and rounds >= 2 and 5 * ks <= 2 * sms else 1
    return {
        "pieces": pieces, "threads": threads, "parts": parts,
        "wc_blocks": max(1, min(sms - 2 * ks if zs_parts == 2 else max(ks, sms - ks), ks * rounds)),
        "zp": zp,
        "fwd_tile": int(fwd_tile), "fwd_smem": _BAR + (tile if fwd_tile else 0) + idx,
        "bwd_tile": int(bwd_tile), "bwd_lists": int(bwd_lists), "scratch": scratch,
        "room": room, "bwd_smem": _BAR + room + (entries if bwd_lists else 0) + small,
        "zs_parts": zs_parts,
    }


def bwd_workspace_bytes(plan: Dict[str, int], k: int, s: int, u: int, n: int, l: int) -> int:
    """The backward's workspace (``csrc/cpc_select.cu:work_block`` per d_zs
    block): none where the d_zs lists fit shared memory, else a region of
    scratch and entries for each of the K S d_zs blocks (one per (k, s))."""
    if plan["bwd_lists"]:
        return 0
    return (plan["scratch"] + u * l * (n + 1) * 8) * k * s


def check_select_inputs(wc, zs, utt_index, seq_index) -> None:
    """Raise ``ValueError`` on what the kernels do not take: wc and z_shift
    (K, S, U, L, Z) f32, utt_index (K, U, N) and seq_index (K, S, U, N, L)
    int32, all contiguous on one device."""
    if wc.dim() != 5:
        raise ValueError(f"wc must be (K, S, U, L, Z); got {tuple(wc.shape)}")
    k, s, u, l, z = wc.shape
    n = utt_index.shape[-1] if utt_index.dim() == 3 else -1
    expect_tensors({
        "wc": (wc, torch.float32, wc.shape),
        "z_shift": (zs, torch.float32, wc.shape),
        "utt_index": (utt_index, torch.int32, (k, u, n)),
        "seq_index": (seq_index, torch.int32, (k, s, u, n, l)),
    }, wc.device, "wc")
    if min(k, s, u, l, z, n) < 1:
        raise ValueError(f"empty CPC selection: wc {tuple(wc.shape)}, N = {n}")


def _launch(entry: str, what: str, x, *args) -> None:
    """Call the C entry ``entry`` on ``x``'s card and current stream
    (tensors as their data pointers; the device index and stream last)."""
    from . import _build

    dev = x.device.index
    if dev != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(entry, what, x, *args)
    err = getattr(_build.library(), entry)(
        *[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args], dev,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        _build.check(err, what)


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


def _fwd(wc, zs, utt_index, seq_index, stamps=None):
    k, s, u, l, z = wc.shape
    n = utt_index.shape[-1]
    f_neg = torch.empty(k, s, u, n, l, dtype=torch.float32, device=wc.device)
    f_pos = torch.empty(k, s, u, l, dtype=torch.float32, device=wc.device)
    if stamps is None:
        _launch("vq_cpc_select_launch", "cpc_select kernel launch", wc, wc, zs, utt_index,
                seq_index, f_neg, f_pos, k * s, s, u, n, l, z)
    else:
        _launch("vq_cpc_select_stamped_launch", "stamped cpc_select kernel launch", wc, wc, zs,
                utt_index, seq_index, f_neg, f_pos, k * s, s, u, n, l, z, stamps)
    return f_neg, f_pos


def _bwd(d_fneg, d_fpos, wc, zs, utt_index, seq_index, stamps=None):
    from . import _build

    k, s, u, l, z = wc.shape
    n = utt_index.shape[-1]
    d_wc, d_zs = torch.empty_like(wc), torch.empty_like(zs)
    nbytes = _build.library().vq_cpc_select_bwd_workspace(k * s, s, u, n, l, z, wc.device.index)
    work = torch.empty(nbytes, dtype=torch.uint8, device=wc.device) if nbytes > 0 else None
    args = (d_fneg, d_fpos, wc, zs, utt_index, seq_index, d_wc, d_zs, work, k * s, s, u, n, l, z)
    if stamps is None:
        _launch("vq_cpc_select_bwd_launch", "cpc_select_bwd kernel launch", wc, *args)
    else:
        _launch("vq_cpc_select_bwd_stamped_launch", "stamped cpc_select_bwd kernel launch", wc,
                *args, stamps)
    return d_wc, d_zs


def cpc_select(wc, zs, utt_index, seq_index) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f_neg (K, S, U, N, L), f_pos (K, S, U, L)) f32. On a CUDA tensor this
    launches the kernel on the current stream without waiting for it."""
    global CPC_SELECT_LAUNCHES
    on_card = _on_card(wc, "cpc_select")
    check_select_inputs(wc, zs, utt_index, seq_index)
    if not on_card:
        return cpc_select_reference(wc, zs, utt_index, seq_index)
    out = _fwd(wc, zs, utt_index, seq_index)
    CPC_SELECT_LAUNCHES += 1
    return out


def _check_cotangents(d_fneg, d_fpos, wc, n: int) -> None:
    k, s, u, l, _ = wc.shape
    expect_tensors({
        "d_fneg": (d_fneg, torch.float32, (k, s, u, n, l)),
        "d_fpos": (d_fpos, torch.float32, (k, s, u, l)),
    }, wc.device, "wc")


def cpc_select_bwd(d_fneg, d_fpos, wc, zs, utt_index, seq_index):
    """(d_wc, d_zs), both (K, S, U, L, Z) f32. On the card one launch, one
    writer per output row and no atomics: the same bits on every launch."""
    global CPC_SELECT_BWD_LAUNCHES
    on_card = _on_card(wc, "cpc_select_bwd")
    check_select_inputs(wc, zs, utt_index, seq_index)
    _check_cotangents(d_fneg, d_fpos, wc, utt_index.shape[-1])
    if not on_card:
        return cpc_select_bwd_reference(d_fneg, d_fpos, wc, zs, utt_index, seq_index)
    out = _bwd(d_fneg, d_fpos, wc, zs, utt_index, seq_index)
    CPC_SELECT_BWD_LAUNCHES += 1
    return out


def _stamps(wc, phases: int, what: str) -> torch.Tensor:
    if wc.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda only, not {wc.device}")
    return torch.zeros(2, 4 + phases, dtype=torch.int64, device=wc.device)


def cpc_select_stamped(wc, zs, utt_index, seq_index):
    """``cpc_select`` through the kernel's variant that stamps its phases, on
    a CUDA tensor only (a measurement: no entry point of the package calls
    it): (f_neg, f_pos, stamps (2, 4 + len(FWD_STAMP_PHASES)) int64), the
    outputs the plain launch's bits."""
    global CPC_SELECT_STAMPED_LAUNCHES
    check_select_inputs(wc, zs, utt_index, seq_index)
    stamps = _stamps(wc, len(FWD_STAMP_PHASES), "cpc_select_stamped")
    out = _fwd(wc, zs, utt_index, seq_index, stamps)
    CPC_SELECT_STAMPED_LAUNCHES += 1
    return (*out, stamps)


def cpc_select_bwd_stamped(d_fneg, d_fpos, wc, zs, utt_index, seq_index):
    """``cpc_select_bwd`` through the kernel's stamped variant, on a CUDA
    tensor only: (d_wc, d_zs, stamps (2, 4 + len(BWD_STAMP_PHASES)) int64;
    block 0 sums d_zs rows, the last block d_wc rows), the outputs the
    plain launch's bits."""
    global CPC_SELECT_BWD_STAMPED_LAUNCHES
    check_select_inputs(wc, zs, utt_index, seq_index)
    _check_cotangents(d_fneg, d_fpos, wc, utt_index.shape[-1])
    stamps = _stamps(wc, len(BWD_STAMP_PHASES), "cpc_select_bwd_stamped")
    out = _bwd(d_fneg, d_fpos, wc, zs, utt_index, seq_index, stamps)
    CPC_SELECT_BWD_STAMPED_LAUNCHES += 1
    return (*out, stamps)


def summarize_select_stamps(stamps, backward: bool = False) -> Dict[str, Dict[str, dict]]:
    """A stamped selection buffer -> {kernel: {block: {phase: us, ...,
    "total", "wall"}}}: the microseconds thread 0 of block 0 and of the last
    block spent in each phase over the launch (``ar_decode.summarize_stamps``
    with one step), kernel "forward" or "backward"."""
    from .ar_decode import summarize_stamps

    if backward:
        return {"backward": summarize_stamps(stamps, 1, 0, BWD_STAMP_PHASES)}
    return {"forward": summarize_stamps(stamps, 1, 0, FWD_STAMP_PHASES)}


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
