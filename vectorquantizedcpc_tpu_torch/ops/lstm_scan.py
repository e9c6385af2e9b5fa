"""LSTM recurrence over a precomputed input projection: CUDA kernels and plain versions.

Three kernels of ``csrc/lstm_scan.cu``, each a whole sequence in one launch,
the port of the JAX package's ``ops/lstm_scan.py``:

- ``lstm_scan``: the forward's inference variant (``_fwd_kernel`` with
  ``save_residuals=False``), used without gradients;
- ``lstm_scan_train``: the training variant (``save_residuals=True``),
  which also returns the activated gates ``acts`` (bf16) and the cell
  states entering each step ``c_prev`` (f32);
- ``lstm_scan_bwd``: the reverse-time backward (``_bwd_kernel``).

Torch gate order i, f, g, o::

    gates = f32(xproj[t]) + bf16(h) @ wh          (f32 accumulation)
    c = sigmoid(f) * c + sigmoid(i) * tanh(g)    (f32 carry)
    h = sigmoid(o) * tanh(c)                     (f32 carry)

``hs`` is stored in bf16. Any T >= 1 is taken (the TPU kernel's time-chunk
divisor has no counterpart here). ``LstmScan`` is the autograd Function
around the training pair, the counterpart of ``fused_lstm_scan``'s custom
VJP: its backward runs ``lstm_scan_bwd`` and one f32 product for ``dwh``.
Each ``*_reference`` rounds at the kernel's places; a wrapper uses it for
CPU tensors only: a CUDA tensor launches the kernel or raises. The
``LSTM_SCAN*_LAUNCHES`` counters count launches.
"""

from typing import Tuple

import torch

from ._build import on_card as _on_card

LSTM_SCAN_LAUNCHES = 0
LSTM_SCAN_TRAIN_LAUNCHES = 0
LSTM_SCAN_BWD_LAUNCHES = 0
CLUSTER = 8  # kCluster in csrc/lstm_scan.cu: CTAs per cluster, each U = H / 8 units
ROWS = 8  # kRows: batch rows per cluster
SPLIT = 2  # kSplit: parts of the forward's H-deep product
BWD_SPLIT = 8  # kBwdSplit: parts of the backward's 4H-deep product
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block can opt into (227 KB)
MAX_THREADS = 1024  # the kernels run H threads per CTA

Tensors3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def scan_smem_bytes(hidden: int) -> int:
    """Dynamic shared memory of one forward CTA at width ``hidden`` (csrc make_layout)."""
    c4 = 4 * (hidden // CLUSTER)
    return (
        _align16(2 * hidden * c4)  # this CTA's wh columns, bf16
        + _align16(4 * 2 * hidden * ROWS)  # bf16(h) tile, two buffers, as f32
        + _align16(4 * SPLIT * ROWS * c4)  # the product's parts
    )


def bwd_smem_bytes(hidden: int) -> int:
    """Dynamic shared memory of one backward CTA (csrc make_bwd_layout)."""
    units = hidden // CLUSTER
    return (
        _align16(2 * units * 4 * hidden)  # this CTA's wh rows, bf16
        + _align16(4 * 2 * 4 * hidden * ROWS)  # bf16(da) tile, two buffers, as f32
        + _align16(4 * BWD_SPLIT * ROWS * units)  # the product's parts
    )


def _gates(xproj_t, h, whf, hidden):
    gates = xproj_t.float() + h.bfloat16().float() @ whf
    gi, gf, gg, go = gates.split(hidden, dim=1)
    return torch.sigmoid(gi), torch.sigmoid(gf), torch.tanh(gg), torch.sigmoid(go)


@torch.no_grad()
def _scan_reference(wh, xproj, h0, c0, save: bool):
    hidden = wh.shape[0]
    whf = wh.float()
    h, c = h0.float().clone(), c0.float().clone()
    t, b = xproj.shape[:2]
    hs = torch.empty(t, b, hidden, dtype=torch.bfloat16, device=xproj.device)
    if save:
        acts = torch.empty(t, b, 4 * hidden, dtype=torch.bfloat16, device=xproj.device)
        c_prev = torch.empty(t, b, hidden, dtype=torch.float32, device=xproj.device)
    for i in range(t):
        if save:
            c_prev[i] = c
        ig, fg, gg, og = _gates(xproj[i], h, whf, hidden)
        c = fg * c + ig * gg
        h = og * torch.tanh(c)
        hs[i] = h.bfloat16()
        if save:
            acts[i] = torch.cat([ig, fg, gg, og], dim=1).bfloat16()
    return (hs, acts, c_prev, h, c) if save else (hs, h, c)


def lstm_scan_reference(
    wh: torch.Tensor, xproj: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor
) -> Tensors3:
    """Plain version of the inference kernel: (hs (T, B, H) bf16, h_T, c_T (B, H) f32)."""
    return _scan_reference(wh, xproj, h0, c0, save=False)


def lstm_scan_train_reference(wh, xproj, h0, c0):
    """Plain version of the training kernel: (hs, acts (T, B, 4H) bf16,
    c_prev (T, B, H) f32, h_T, c_T)."""
    return _scan_reference(wh, xproj, h0, c0, save=True)


@torch.no_grad()
def lstm_scan_bwd_reference(acts, c_prev, dhs, wh, dh_t, dc_t) -> Tensors3:
    """Plain version of the backward kernel: (dgates (T, B, 4H) bf16, dh0, dc0 (B, H) f32)."""
    hidden = wh.shape[0]
    wht = wh.float().t()
    dh, dc = dh_t.float().clone(), dc_t.float().clone()
    dgates = torch.empty_like(acts)
    for t in reversed(range(acts.shape[0])):
        i, f, g, o = acts[t].float().split(hidden, dim=1)
        cp = c_prev[t]
        tc = torch.tanh(f * cp + i * g)
        dh = dh + dhs[t].float()
        do = dh * tc
        dc = dc + dh * o * (1.0 - tc * tc)
        da = torch.cat(
            [dc * g * i * (1.0 - i), dc * cp * f * (1.0 - f), dc * i * (1.0 - g * g),
             do * o * (1.0 - o)], dim=1,
        ).bfloat16()
        dgates[t] = da
        dh = da.float() @ wht
        dc = dc * f
    return dgates, dh, dc


def _check(tensors: dict, device: torch.device) -> None:
    for name, (x, dtype, shape) in tensors.items():
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, xproj on {device}")
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got {x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_widths(hidden: int, smem: int, what: str, widest: int) -> None:
    if hidden % CLUSTER or hidden > MAX_THREADS:
        raise ValueError(f"H={hidden}: the kernel takes H a multiple of {CLUSTER}, "
                         f"at most {MAX_THREADS}")
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"H={hidden} needs {smem} B of shared memory per {what} CTA; the limit of "
            f"one H100 block is {SMEM_LIMIT} B (227 KB), so H <= {widest}"
        )


def check_scan_inputs(wh, xproj, h0, c0, kernel: bool = False) -> None:
    """Raise ``ValueError`` on what the forward kernels do not take.

    wh (H, 4H) bf16, xproj (T, B, 4H) bf16, h0 and c0 (B, H) f32, all
    contiguous on one device. With ``kernel`` also the kernel's widths: H a
    multiple of 8, within one CTA's threads and shared memory.
    """
    if wh.dim() != 2 or xproj.dim() != 3:
        raise ValueError(f"wh must be (H, 4H) and xproj (T, B, 4H); got {tuple(wh.shape)}, "
                         f"{tuple(xproj.shape)}")
    hidden = wh.shape[0]
    t, b = xproj.shape[:2]
    _check({
        "wh": (wh, torch.bfloat16, (hidden, 4 * hidden)),
        "xproj": (xproj, torch.bfloat16, (t, b, 4 * hidden)),
        "h0": (h0, torch.float32, (b, hidden)),
        "c0": (c0, torch.float32, (b, hidden)),
    }, xproj.device)
    if t < 1 or b < 1 or hidden < 1:
        raise ValueError(f"empty LSTM scan: xproj {tuple(xproj.shape)}")
    if kernel:
        _check_widths(hidden, scan_smem_bytes(hidden), "forward", 432)


def check_bwd_inputs(acts, c_prev, dhs, wh, dh_t, dc_t, kernel: bool = False) -> None:
    """Raise ``ValueError`` on what the backward kernel does not take: acts
    (T, B, 4H) bf16, c_prev (T, B, H) f32, dhs (T, B, H) bf16, wh (H, 4H)
    bf16, dh_t and dc_t (B, H) f32; with ``kernel`` H <= 352 as well."""
    if acts.dim() != 3 or wh.dim() != 2:
        raise ValueError(f"acts must be (T, B, 4H) and wh (H, 4H); got {tuple(acts.shape)}, "
                         f"{tuple(wh.shape)}")
    t, b = acts.shape[:2]
    hidden = wh.shape[0]
    _check({
        "acts": (acts, torch.bfloat16, (t, b, 4 * hidden)),
        "c_prev": (c_prev, torch.float32, (t, b, hidden)),
        "dhs": (dhs, torch.bfloat16, (t, b, hidden)),
        "wh": (wh, torch.bfloat16, (hidden, 4 * hidden)),
        "dh_t": (dh_t, torch.float32, (b, hidden)),
        "dc_t": (dc_t, torch.float32, (b, hidden)),
    }, acts.device)
    if t < 1 or b < 1 or hidden < 1:
        raise ValueError(f"empty LSTM scan backward: acts {tuple(acts.shape)}")
    if kernel:
        _check_widths(hidden, bwd_smem_bytes(hidden), "backward", 352)


def _launch(entry: str, what: str, device: torch.device, *args) -> None:
    from . import _build

    with torch.cuda.device(device):
        err = getattr(_build.library(), entry)(
            *[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args],
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(err, what)


def lstm_scan(
    wh: torch.Tensor, xproj: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor
) -> Tensors3:
    """LSTM over ``xproj`` from (h0, c0): (hs (T, B, H) bf16, h_T, c_T (B, H) f32).

    On a CUDA tensor this launches the inference kernel on the current
    stream and returns without waiting for it; on a CPU tensor it runs the
    plain version.
    """
    global LSTM_SCAN_LAUNCHES
    on_card = _on_card(xproj, "lstm_scan")
    check_scan_inputs(wh, xproj, h0, c0, kernel=on_card)
    if not on_card:
        return lstm_scan_reference(wh, xproj, h0, c0)
    t, b, _ = xproj.shape
    hidden = wh.shape[0]
    hs = torch.empty(t, b, hidden, dtype=torch.bfloat16, device=xproj.device)
    h_out = torch.empty(b, hidden, dtype=torch.float32, device=xproj.device)
    c_out = torch.empty_like(h_out)
    _launch("vq_lstm_scan_launch", "lstm_scan kernel launch", xproj.device,
            xproj, wh, h0, c0, hs, h_out, c_out, t, b, hidden)
    LSTM_SCAN_LAUNCHES += 1
    return hs, h_out, c_out


def lstm_scan_train(wh, xproj, h0, c0):
    """The training forward: (hs, acts (T, B, 4H) bf16, c_prev (T, B, H) f32,
    h_T, c_T). hs, h_T and c_T are ``lstm_scan``'s bits."""
    global LSTM_SCAN_TRAIN_LAUNCHES
    on_card = _on_card(xproj, "lstm_scan_train")
    check_scan_inputs(wh, xproj, h0, c0, kernel=on_card)
    if not on_card:
        return lstm_scan_train_reference(wh, xproj, h0, c0)
    t, b, g4 = xproj.shape
    hidden = wh.shape[0]
    dev = xproj.device
    hs = torch.empty(t, b, hidden, dtype=torch.bfloat16, device=dev)
    acts = torch.empty(t, b, g4, dtype=torch.bfloat16, device=dev)
    c_prev = torch.empty(t, b, hidden, dtype=torch.float32, device=dev)
    h_out = torch.empty(b, hidden, dtype=torch.float32, device=dev)
    c_out = torch.empty_like(h_out)
    _launch("vq_lstm_scan_train_launch", "lstm_scan_train kernel launch", dev,
            xproj, wh, h0, c0, hs, acts, c_prev, h_out, c_out, t, b, hidden)
    LSTM_SCAN_TRAIN_LAUNCHES += 1
    return hs, acts, c_prev, h_out, c_out


def lstm_scan_bwd(acts, c_prev, dhs, wh, dh_t, dc_t) -> Tensors3:
    """The reverse-time backward: (dgates (T, B, 4H) bf16, dh0, dc0 (B, H) f32)."""
    global LSTM_SCAN_BWD_LAUNCHES
    on_card = _on_card(acts, "lstm_scan_bwd")
    check_bwd_inputs(acts, c_prev, dhs, wh, dh_t, dc_t, kernel=on_card)
    if not on_card:
        return lstm_scan_bwd_reference(acts, c_prev, dhs, wh, dh_t, dc_t)
    t, b, _ = acts.shape
    hidden = wh.shape[0]
    dgates = torch.empty_like(acts)
    dh0 = torch.empty(b, hidden, dtype=torch.float32, device=acts.device)
    dc0 = torch.empty_like(dh0)
    _launch("vq_lstm_scan_bwd_launch", "lstm_scan_bwd kernel launch", acts.device,
            acts, c_prev, dhs, wh, dh_t, dc_t, dgates, dh0, dc0, t, b, hidden)
    LSTM_SCAN_BWD_LAUNCHES += 1
    return dgates, dh0, dc0


class LstmScan(torch.autograd.Function):
    """Differentiable scan: ``lstm_scan_train`` forward, ``lstm_scan_bwd``
    backward, as ``fused_lstm_scan``'s ``_fused_fwd`` / ``_fused_bwd``.

    Outside the backward kernel: h_prevs = [bf16(h0), hs[:-1]];
    dwh = h_prevs^T dgates summed in f32, cast to wh's dtype; dxproj =
    dgates in xproj's dtype; dh0, dc0 in h0's dtype. Missing cotangents of
    h_T and c_T count as zeros.
    """

    @staticmethod
    def forward(ctx, wh, xproj, h0, c0):
        hs, acts, c_prev, h_t, c_t = lstm_scan_train(wh, xproj, h0, c0)
        ctx.save_for_backward(wh, h0, acts, c_prev, hs)
        ctx.xproj_dtype = xproj.dtype
        return hs, h_t, c_t

    @staticmethod
    def backward(ctx, dhs, dh_t, dc_t):
        wh, h0, acts, c_prev, hs = ctx.saved_tensors
        if dhs is None:
            dhs = torch.zeros_like(hs)
        dh_t = torch.zeros_like(h0, dtype=torch.float32) if dh_t is None else dh_t
        dc_t = torch.zeros_like(h0, dtype=torch.float32) if dc_t is None else dc_t
        dgates, dh0, dc0 = lstm_scan_bwd(
            acts, c_prev, dhs.bfloat16().contiguous(), wh,
            dh_t.float().contiguous(), dc_t.float().contiguous(),
        )
        h_prevs = torch.cat([h0.bfloat16()[None], hs[:-1]], dim=0)  # (T, B, H)
        hidden = wh.shape[0]
        dwh = (h_prevs.reshape(-1, hidden).float().t() @ dgates.reshape(-1, 4 * hidden).float())
        return dwh.to(wh.dtype), dgates.to(ctx.xproj_dtype), dh0.to(h0.dtype), dc0.to(h0.dtype)
