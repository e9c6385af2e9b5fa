"""LSTM recurrence over a precomputed input projection: CUDA kernel and plain version.

``lstm_scan`` runs a whole sequence in one launch of the kernel in
``csrc/lstm_scan.cu``, the port of the JAX package's
``ops/lstm_scan.py:_fwd_kernel`` in its residual-free inference variant
(``save_residuals=False``). Torch gate order i, f, g, o::

    gates = f32(xproj[t]) + bf16(h) @ wh          (f32 accumulation)
    c = sigmoid(f) * c + sigmoid(i) * tanh(g)    (f32 carry)
    h = sigmoid(o) * tanh(c)                     (f32 carry)

``hs`` is stored in bf16. Any T >= 1 is taken (the TPU kernel's time-chunk
divisor has no counterpart here). ``lstm_scan_reference`` rounds at the
same places; the wrapper uses it for CPU tensors only: a CUDA tensor
launches the kernel or raises. ``LSTM_SCAN_LAUNCHES`` counts launches.
There is no autograd here: the residual-saving training variant and its
backward are the CPC-training slice's.
"""

from typing import Tuple

import torch

LSTM_SCAN_LAUNCHES = 0
CLUSTER = 8  # kCluster in csrc/lstm_scan.cu: CTAs per cluster, each U = H / 8 units
ROWS = 8  # kRows: batch rows per cluster
SPLIT = 2  # kSplit: parts of the H-deep product
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block can opt into (227 KB)
MAX_THREADS = 1024  # the kernel runs H threads per CTA


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def scan_smem_bytes(hidden: int) -> int:
    """Dynamic shared memory of one CTA at width ``hidden`` (csrc make_layout)."""
    c4 = 4 * (hidden // CLUSTER)
    return (
        _align16(2 * hidden * c4)  # this CTA's wh columns, bf16
        + _align16(4 * 2 * hidden * ROWS)  # bf16(h) tile, two buffers, as f32
        + _align16(4 * SPLIT * ROWS * c4)  # the product's parts
    )


@torch.no_grad()
def lstm_scan_reference(
    wh: torch.Tensor, xproj: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: (hs (T, B, H) bf16, h_T, c_T (B, H) f32)."""
    hidden = wh.shape[0]
    whf = wh.float()
    h, c = h0.float().clone(), c0.float().clone()
    hs = torch.empty(xproj.shape[:2] + (hidden,), dtype=torch.bfloat16, device=xproj.device)
    for t in range(xproj.shape[0]):
        gates = xproj[t].float() + h.bfloat16().float() @ whf
        gi, gf, gg, go = gates.split(hidden, dim=1)
        c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        h = torch.sigmoid(go) * torch.tanh(c)
        hs[t] = h.bfloat16()
    return hs, h, c


def check_scan_inputs(wh, xproj, h0, c0, kernel: bool = False) -> None:
    """Raise ``ValueError`` on what the kernel does not take.

    wh (H, 4H) bf16, xproj (T, B, 4H) bf16, h0 and c0 (B, H) f32, all
    contiguous on one device. With ``kernel`` also the kernel's widths: H a
    multiple of 8, within one CTA's threads and shared memory.
    """
    if wh.dim() != 2 or xproj.dim() != 3:
        raise ValueError(f"wh must be (H, 4H) and xproj (T, B, 4H); got {tuple(wh.shape)}, "
                         f"{tuple(xproj.shape)}")
    hidden = wh.shape[0]
    t, b = xproj.shape[:2]
    expect = {
        "wh": (wh, torch.bfloat16, (hidden, 4 * hidden)),
        "xproj": (xproj, torch.bfloat16, (t, b, 4 * hidden)),
        "h0": (h0, torch.float32, (b, hidden)),
        "c0": (c0, torch.float32, (b, hidden)),
    }
    for name, (x, dtype, shape) in expect.items():
        if x.device != xproj.device:
            raise ValueError(f"{name} is on {x.device}, xproj on {xproj.device}")
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got {x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if t < 1 or b < 1 or hidden < 1:
        raise ValueError(f"empty LSTM scan: xproj {tuple(xproj.shape)}")
    if not kernel:
        return
    if hidden % CLUSTER or hidden > MAX_THREADS:
        raise ValueError(f"H={hidden}: the kernel takes H a multiple of {CLUSTER}, "
                         f"at most {MAX_THREADS}")
    if scan_smem_bytes(hidden) > SMEM_LIMIT:
        raise ValueError(
            f"H={hidden} needs {scan_smem_bytes(hidden)} B of shared memory per CTA; "
            f"the limit of one H100 block is {SMEM_LIMIT} B (227 KB), so H <= 432"
        )


def lstm_scan(
    wh: torch.Tensor, xproj: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LSTM over ``xproj`` from (h0, c0): (hs (T, B, H) bf16, h_T, c_T (B, H) f32).

    On a CUDA tensor this launches the kernel on the current stream and
    returns without waiting for it; on a CPU tensor it runs the plain
    version.
    """
    global LSTM_SCAN_LAUNCHES
    check_scan_inputs(wh, xproj, h0, c0, kernel=xproj.device.type != "cpu")
    if xproj.device.type == "cpu":
        return lstm_scan_reference(wh, xproj, h0, c0)
    if xproj.device.type != "cuda":
        raise ValueError(f"lstm_scan runs on cuda or cpu, not {xproj.device}")
    from . import _build

    t, b, _ = xproj.shape
    hidden = wh.shape[0]
    hs = torch.empty(t, b, hidden, dtype=torch.bfloat16, device=xproj.device)
    h_out = torch.empty(b, hidden, dtype=torch.float32, device=xproj.device)
    c_out = torch.empty_like(h_out)
    with torch.cuda.device(xproj.device):
        err = _build.library().vq_lstm_scan_launch(
            *[x.data_ptr() for x in (xproj, wh, h0, c0, hs, h_out, c_out)], t, b, hidden,
            torch.cuda.current_stream(xproj.device).cuda_stream,
        )
    _build.check(err, "lstm_scan kernel launch")
    LSTM_SCAN_LAUNCHES += 1
    return hs, h_out, c_out

