"""GRU recurrence over a precomputed input projection: CUDA kernels and plain versions.

``gru_scan`` and ``gru_scan_masked`` run a whole sequence in one launch of
the kernels in ``csrc/gru_scan.cu``, the port of the JAX package's
``ops/gru_train.py:_fwd_kernel`` (the no-residual, no-grad variant) and
``ops/gru_train.py:_fwd_kernel_masked``. Torch gate order r, z, n, with
``bh`` inside the reset product::

    hproj = bf16(h) @ wh + bh                 (f32 accumulation)
    r = sigmoid(xr + hr); z = sigmoid(xz + hz); n = tanh(xn + r * hn)
    h = (1 - z) * n + z * h                   (f32 carry)
    masked: rows whose valid[t, b] is 0 keep their carry at step t

``hs`` is stored in bf16. ``gru_scan_reference`` and
``gru_scan_masked_reference`` round at the same places; the wrappers use
them for CPU tensors only: a CUDA tensor launches the kernel or raises.
``GRU_SCAN_LAUNCHES`` and ``GRU_SCAN_MASKED_LAUNCHES`` count launches.
Serving is no-grad: there is no autograd here (the backward is the
vocoder-training slice's).
"""

from typing import Tuple

import torch

GRU_SCAN_LAUNCHES = 0
GRU_SCAN_MASKED_LAUNCHES = 0
ROWS = 8  # kRows in csrc/gru_scan.cu: batch rows per block
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block can opt into (227 KB)


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def scan_smem_bytes(hidden: int) -> int:
    """Dynamic shared memory of one block at width ``hidden`` (csrc make_layout)."""
    h3 = 3 * hidden
    return (
        _align16(2 * hidden * h3)  # wh bf16
        + _align16(4 * h3)  # bh
        + 2 * _align16(4 * ROWS * hidden)  # h f32 and bf16(h)
        + _align16(4 * ROWS * h3)  # hproj
    )


@torch.no_grad()
def _scan_reference(wh, bh, xproj, h0, valid):
    hidden = wh.shape[0]
    whf = wh.float()
    h = h0.float().clone()
    hs = torch.empty(xproj.shape[:2] + (hidden,), dtype=torch.bfloat16, device=xproj.device)
    for t in range(xproj.shape[0]):
        hproj = h.bfloat16().float() @ whf + bh.float()
        xr, xz, xn = xproj[t].float().split(hidden, dim=1)
        hr, hz, hn = hproj.split(hidden, dim=1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_new = (1.0 - z) * n + z * h
        if valid is not None:
            h_new = torch.where(valid[t, :, None] != 0, h_new, h)
        hs[t] = h_new.bfloat16()
        h = h_new
    return hs, h


def gru_scan_reference(
    wh: torch.Tensor, bh: torch.Tensor, xproj: torch.Tensor, h0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: (hs (T, B, H) bf16, h_T (B, H) f32)."""
    return _scan_reference(wh, bh, xproj, h0, None)


def gru_scan_masked_reference(
    wh: torch.Tensor,
    bh: torch.Tensor,
    xproj: torch.Tensor,
    valid: torch.Tensor,
    h0: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the masked kernel: (hs (T, B, H) bf16, h_T (B, H) f32)."""
    return _scan_reference(wh, bh, xproj, h0, valid)


def check_scan_inputs(wh, bh, xproj, h0, valid=None, kernel: bool = False) -> None:
    """Raise ``ValueError`` on what the kernels do not take.

    wh (H, 3H) bf16, bh (3H,) f32, xproj (T, B, 3H) bf16, h0 (B, H) f32,
    valid (T, B) int32, all contiguous on one device. With ``kernel`` also
    the shared-memory limit of one block.
    """
    if wh.dim() != 2 or xproj.dim() != 3:
        raise ValueError(f"wh must be (H, 3H) and xproj (T, B, 3H); got {tuple(wh.shape)}, "
                         f"{tuple(xproj.shape)}")
    hidden = wh.shape[0]
    t, b = xproj.shape[:2]
    expect = {
        "wh": (wh, torch.bfloat16, (hidden, 3 * hidden)),
        "bh": (bh, torch.float32, (3 * hidden,)),
        "xproj": (xproj, torch.bfloat16, (t, b, 3 * hidden)),
        "h0": (h0, torch.float32, (b, hidden)),
    }
    if valid is not None:
        expect["valid"] = (valid, torch.int32, (t, b))
    for name, (x, dtype, shape) in expect.items():
        if x.device != xproj.device:
            raise ValueError(f"{name} is on {x.device}, xproj on {xproj.device}")
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got {x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if t < 1 or b < 1 or hidden < 1:
        raise ValueError(f"empty GRU scan: xproj {tuple(xproj.shape)}")
    if kernel and scan_smem_bytes(hidden) > SMEM_LIMIT:
        raise ValueError(
            f"H={hidden} needs {scan_smem_bytes(hidden)} B of shared memory per block; "
            f"the limit of one H100 block is {SMEM_LIMIT} B (227 KB), so H <= 183"
        )


def _launch(entry: str, xproj, valid, wh, bh, h0):
    from . import _build

    t, b, _ = xproj.shape
    hidden = wh.shape[0]
    hs = torch.empty(t, b, hidden, dtype=torch.bfloat16, device=xproj.device)
    h_out = torch.empty(b, hidden, dtype=torch.float32, device=xproj.device)
    ptrs = [xproj] + ([valid] if valid is not None else []) + [wh, bh, h0, hs, h_out]
    with torch.cuda.device(xproj.device):
        err = getattr(_build.library(), entry)(
            *[x.data_ptr() for x in ptrs], t, b, hidden,
            torch.cuda.current_stream(xproj.device).cuda_stream,
        )
    _build.check(err, f"{entry} kernel launch")
    return hs, h_out


def gru_scan(
    wh: torch.Tensor, bh: torch.Tensor, xproj: torch.Tensor, h0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GRU over ``xproj`` from ``h0``: (hs (T, B, H) bf16, h_T (B, H) f32).

    On a CUDA tensor this launches the kernel on the current stream and
    returns without waiting for it; on a CPU tensor it runs the plain
    version.
    """
    global GRU_SCAN_LAUNCHES
    check_scan_inputs(wh, bh, xproj, h0, kernel=xproj.device.type != "cpu")
    if xproj.device.type == "cpu":
        return gru_scan_reference(wh, bh, xproj, h0)
    if xproj.device.type != "cuda":
        raise ValueError(f"gru_scan runs on cuda or cpu, not {xproj.device}")
    out = _launch("vq_gru_scan_launch", xproj, None, wh, bh, h0)
    GRU_SCAN_LAUNCHES += 1
    return out


def gru_scan_masked(
    wh: torch.Tensor,
    bh: torch.Tensor,
    xproj: torch.Tensor,
    valid: torch.Tensor,
    h0: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """As ``gru_scan``, but rows keep their carry where ``valid[t, b]`` is 0."""
    global GRU_SCAN_MASKED_LAUNCHES
    check_scan_inputs(wh, bh, xproj, h0, valid, kernel=xproj.device.type != "cpu")
    if xproj.device.type == "cpu":
        return gru_scan_masked_reference(wh, bh, xproj, valid, h0)
    if xproj.device.type != "cuda":
        raise ValueError(f"gru_scan_masked runs on cuda or cpu, not {xproj.device}")
    out = _launch("vq_gru_scan_masked_launch", xproj, valid, wh, bh, h0)
    GRU_SCAN_MASKED_LAUNCHES += 1
    return out


def fused_gru_scan(
    wh: torch.Tensor, bh: torch.Tensor, xproj: torch.Tensor, h0: torch.Tensor
) -> torch.Tensor:
    """The JAX package's ``fused_gru_scan`` (forward, no grad): hs (T, B, H) bf16."""
    return gru_scan(wh, bh, xproj, h0)[0]


def fused_gru_scan_masked(
    wh: torch.Tensor,
    bh: torch.Tensor,
    xproj: torch.Tensor,
    valid: torch.Tensor,
    h0: torch.Tensor,
) -> torch.Tensor:
    """The JAX package's ``fused_gru_scan_masked``: hs (T, B, H) bf16."""
    return gru_scan_masked(wh, bh, xproj, valid, h0)[0]
