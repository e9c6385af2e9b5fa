"""Profiling helpers: the JAX package's ``utils/profiling.py`` on PyTorch.

- :func:`trace`: a context manager over ``torch.profiler.profile`` that
  writes one Chrome trace into a directory. Both trainers open it around a
  few steps after their first dispatch group when ``runtime.profile_dir``
  is set.
- :func:`device_time`: what a finished trace says of the device: busy ms
  per step, device operations per step and the largest of them.
- :func:`enable_nan_checks`: autograd's anomaly mode, the counterpart of
  ``jax_debug_nans`` (no trainer turns it on).
- :class:`StepTimer`: steps/s on the host clock.
"""

import contextlib
import os
import time
from pathlib import Path
from typing import Iterator, Optional, Union

import torch


@contextlib.contextmanager
def trace(
    profile_dir: Optional[Union[str, Path]],
    device: Optional[Union[str, torch.device]] = None,
) -> Iterator[Optional["torch.profiler.profile"]]:
    """Trace the block into ``profile_dir`` as one Chrome trace
    (``trace_{pid}_{ns}.json``); yields the profile, readable by
    :func:`device_time` after the block. The CPU is traced, and the card
    too when ``device`` is a CUDA device, whose queued work is waited for
    before the trace stops. With no ``profile_dir`` nothing is traced and
    the block gets None."""
    if not profile_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    on_card = device is not None and torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if on_card:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))


def device_time(prof: "torch.profiler.profile", n_steps: int, top: int = 8) -> dict:
    """A finished trace of ``n_steps`` steps -> ``device_busy_ms`` (the sum
    of the device operations' own time per step, None where the trace holds
    no device time), ``device_ops_per_step`` and ``largest``: the ``top``
    operations by device time, as (name, launches per step, ms per step).
    User annotations (Adam's step range) span kernels counted on their own
    and are left out."""
    from torch.autograd import DeviceType

    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3 / n_steps
    if busy_ms <= 0:
        return {"device_busy_ms": None, "device_ops_per_step": 0.0, "largest": []}
    largest = sorted(ops, key=lambda e: -e.self_device_time_total)[:top]
    return {
        "device_busy_ms": busy_ms,
        "device_ops_per_step": sum(e.count for e in ops) / n_steps,
        "largest": [(e.key, e.count / n_steps, e.self_device_time_total / 1e3 / n_steps)
                    for e in largest],
    }


def enable_nan_checks(enable: bool = True) -> None:
    """Autograd's anomaly mode: a backward that makes a NaN raises, naming
    the forward operation. Its checks wait for the device, so it cannot be
    captured in a CUDA graph: use it on eager steps (or the CPU) only."""
    torch.autograd.set_detect_anomaly(enable)


class StepTimer:
    """Rolling steps/s meter (host wall clock)."""

    def __init__(self):
        self.t0 = time.time()
        self.count = 0

    def tick(self, n: int = 1) -> None:
        self.count += n

    def rate(self, reset: bool = True) -> float:
        dt = time.time() - self.t0
        r = self.count / dt if dt > 0 else 0.0
        if reset:
            self.t0, self.count = time.time(), 0
        return r
