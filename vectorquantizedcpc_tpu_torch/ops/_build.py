"""Build the package's CUDA sources into one shared library and load it.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a`` and linked into one library with a plain C
interface, loaded with ``ctypes``. The build lands in ``build/torch_kernels/``
beside the package, named by a hash of the sources, their headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and an
unchanged one is not. Nothing here runs at import
time: the first kernel call builds.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None
build_log = ""  # the compilers' output of the last build in this process


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libvqcpc_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless this exact build exists; returns its path."""
    global build_log
    lib_path = _library_path()
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(str(obj))
            procs.append(
                subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                    text=True,
                )
            )
        logs, failed = [], False
        for src, proc in zip(_sources(), procs):
            out, _ = proc.communicate()
            logs.append(f"[{src.name}]\n{out}")
            failed |= proc.returncode != 0
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, ARCH, "-shared", *objs, "-o", str(tmp_lib)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp_lib, lib_path)
    build_log = "\n".join(logs)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        lib.vq_ar_decode_launch.argtypes = [p] * 18 + [i] * 8 + [u, p]
        lib.vq_ar_decode_launch.restype = i
        lib.vq_ar_decode_stamped_launch.argtypes = [p] * 18 + [i] * 8 + [u, p, p]
        lib.vq_ar_decode_stamped_launch.restype = i
        lib.vq_ar_decode_plan.argtypes = [i] * 5 + [ctypes.POINTER(i)]
        lib.vq_ar_decode_plan.restype = i
        lib.vq_dual_decode_launch.argtypes = [p] * 24 + [i] * 6 + [u, p]
        lib.vq_dual_decode_launch.restype = i
        lib.vq_dual_decode_stamped_launch.argtypes = [p] * 24 + [i] * 6 + [u, p, p]
        lib.vq_dual_decode_stamped_launch.restype = i
        lib.vq_dual_decode_plan.argtypes = [i] * 3 + [ctypes.POINTER(i)]
        lib.vq_dual_decode_plan.restype = i
        lib.vq_gru_scan_launch.argtypes = [p] * 6 + [i] * 3 + [p]
        lib.vq_gru_scan_launch.restype = i
        lib.vq_gru_scan_masked_launch.argtypes = [p] * 7 + [i] * 3 + [p]
        lib.vq_gru_scan_masked_launch.restype = i
        lib.vq_gru_scan_smem_bytes.argtypes = [i]
        lib.vq_gru_scan_smem_bytes.restype = i
        lib.vq_gru_grid_plan.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.vq_gru_grid_plan.restype = i
        lib.vq_gru_scan_grid_launch.argtypes = [p] * 10 + [i] * 4 + [p]
        lib.vq_gru_scan_grid_launch.restype = i
        lib.vq_gru_scan_bwd_launch.argtypes = [p] * 10 + [i] * 3 + [p]
        lib.vq_gru_scan_bwd_launch.restype = i
        lib.vq_gru_scan_grid_stamped_launch.argtypes = [p] * 10 + [i] * 4 + [p, p]
        lib.vq_gru_scan_grid_stamped_launch.restype = i
        lib.vq_gru_scan_bwd_stamped_launch.argtypes = [p] * 10 + [i] * 3 + [p, p]
        lib.vq_gru_scan_bwd_stamped_launch.restype = i
        lib.vq_lstm_scan_launch.argtypes = [p] * 7 + [i] * 3 + [p]
        lib.vq_lstm_scan_launch.restype = i
        lib.vq_lstm_scan_smem_bytes.argtypes = [i]
        lib.vq_lstm_scan_smem_bytes.restype = i
        lib.vq_lstm_scan_train_launch.argtypes = [p] * 9 + [i] * 3 + [p]
        lib.vq_lstm_scan_train_launch.restype = i
        lib.vq_lstm_scan_bwd_launch.argtypes = [p] * 9 + [i] * 3 + [p]
        lib.vq_lstm_scan_bwd_launch.restype = i
        lib.vq_lstm_scan_stamped_launch.argtypes = [p] * 9 + [i] * 4 + [p, p]
        lib.vq_lstm_scan_stamped_launch.restype = i
        lib.vq_lstm_scan_bwd_stamped_launch.argtypes = [p] * 9 + [i] * 3 + [p, p]
        lib.vq_lstm_scan_bwd_stamped_launch.restype = i
        lib.vq_lstm_scan_bwd_smem_bytes.argtypes = [i]
        lib.vq_lstm_scan_bwd_smem_bytes.restype = i
        lib.vq_lstm_grid_plan.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.vq_lstm_grid_plan.restype = i
        lib.vq_lstm_scan_grid_launch.argtypes = [p] * 10 + [i] * 4 + [p]
        lib.vq_lstm_scan_grid_launch.restype = i
        lib.vq_lstm_scan_grid_stamped_launch.argtypes = [p] * 10 + [i] * 4 + [p, p]
        lib.vq_lstm_scan_grid_stamped_launch.restype = i
        lib.vq_lstm_scan_grid_bwd_launch.argtypes = [p] * 10 + [i] * 3 + [p]
        lib.vq_lstm_scan_grid_bwd_launch.restype = i
        lib.vq_lstm_scan_grid_bwd_stamped_launch.argtypes = [p] * 10 + [i] * 3 + [p, p]
        lib.vq_lstm_scan_grid_bwd_stamped_launch.restype = i
        lib.vq_cpc_select_launch.argtypes = [p] * 6 + [i] * 7 + [p]
        lib.vq_cpc_select_launch.restype = i
        lib.vq_cpc_select_stamped_launch.argtypes = [p] * 6 + [i] * 6 + [p, i, p]
        lib.vq_cpc_select_stamped_launch.restype = i
        lib.vq_cpc_select_bwd_launch.argtypes = [p] * 9 + [i] * 7 + [p]
        lib.vq_cpc_select_bwd_launch.restype = i
        lib.vq_cpc_select_bwd_stamped_launch.argtypes = [p] * 9 + [i] * 6 + [p, i, p]
        lib.vq_cpc_select_bwd_stamped_launch.restype = i
        lib.vq_cpc_select_plan.argtypes = [i] * 7 + [ctypes.POINTER(i)]
        lib.vq_cpc_select_plan.restype = i
        lib.vq_cpc_select_bwd_workspace.argtypes = [i] * 7
        lib.vq_cpc_select_bwd_workspace.restype = ctypes.c_longlong
        lib.vq_cuda_error_string.argtypes = [i]
        lib.vq_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def on_card(x, what: str) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA one;
    raises for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")
    return True


def expect_tensors(tensors: dict, device, ref_name: str) -> None:
    """Raise ``ValueError`` unless each ``name: (tensor, dtype, shape)`` of
    ``tensors`` lies on ``device`` (``ref_name``'s), has that dtype and
    shape, and is contiguous: what a kernel's C entry takes on trust."""
    for name, (x, dtype, shape) in tensors.items():
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, {ref_name} on {device}")
        if x.dtype != dtype or tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got {x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def launch(entry: str, what: str, device, *args) -> None:
    """Call the C entry ``entry`` on ``device``'s current stream with
    ``args`` (tensors as their data pointers) and raise on its error."""
    import torch

    with torch.cuda.device(device):
        err = getattr(library(), entry)(
            *[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args],
            torch.cuda.current_stream(device).cuda_stream,
        )
    check(err, what)


def fit_chunk(k: int, size, limit: int) -> int:
    """The K extent a grid block stages at once (csrc/grid_common.cuh
    fit_chunk): all of ``k`` where ``size(k)`` bytes fit ``limit``, else the
    widest multiple of 16 below ``k`` that fits; 0 where none does."""
    if size(k) <= limit:
        return k
    return next((c for c in range((k - 1) // 16 * 16, 15, -16) if size(c) <= limit), 0)


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        msg = library().vq_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
