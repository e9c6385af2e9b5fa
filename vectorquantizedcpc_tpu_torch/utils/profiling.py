"""Profiling helpers: the JAX package's ``utils/profiling.py`` on PyTorch.

- :func:`trace`: a context manager over ``torch.profiler.profile`` that
  writes one Chrome trace into a directory. Both trainers open it around a
  few steps after their first dispatch group when ``runtime.profile_dir``
  is set.
- :func:`device_time`: what a finished trace says of the device: busy ms
  per step, device operations per step and the largest of them.
- :func:`enable_nan_checks`: autograd's anomaly mode, the counterpart of
  ``jax_debug_nans`` (no trainer turns it on).
- :class:`span`: the program's named ranges (``serving.*``, ``data.*``,
  ``step.*``). Every span adds its count and host seconds to the
  process-wide :func:`totals`; while a ``torch.profiler`` collects, it is
  also a range in the trace and an interval in :func:`intervals`, stamped
  on the clock the profiler's events use.
"""

import contextlib
import os
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple, Union

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast


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


MAX_INTERVALS = 1 << 20  # intervals kept while a profiler collects; later ones are dropped

# (name, start_ns, end_ns, thread id, enclosing span's name or None, ids)
Interval = Tuple[str, int, int, int, Optional[str], Dict[str, int]]

_lock = threading.Lock()
_totals: Dict[str, List[float]] = {}
_intervals: List[Interval] = []
_dropped = 0
_open = threading.local()  # .names: the spans open on this thread while collecting


def collecting() -> bool:
    """Whether a ``torch.profiler`` collects anywhere in the process. (The
    C check, ``torch._C._autograd._profiler_enabled()``, answers for the
    profiler's own thread only, and spans open on worker threads too.)"""
    return _autograd_profiler._is_profiler_enabled


class span:
    """``with span("data.wait"):`` times the block into :func:`totals`.

    While a profiler collects (checked once, on entry), the block is also a
    range of that name in its trace and an interval ``(name, start_ns,
    end_ns, thread id, parent, ids)`` in :func:`intervals`. The range is
    ``record_function``'s C++ form, ``_RecordFunctionFast``, whose
    stamps lie microseconds from the interval's (the Python form's exit
    alone takes up to a tenth of a millisecond), and which the profiler
    keeps as an operator, not a user annotation, so no copy of it lands
    among the device's events. The interval's stamps are ``time.time_ns()``,
    the Unix clock of the profiler's events
    (``kineto_results.events()[i].start_ns()``), taken around the range,
    so the interval holds the span's own cost while a profiler collects;
    ``parent`` the innermost span open on the same thread; ``ids`` the
    keywords given here (a request's ``rid``, a ``segment``).
    """

    __slots__ = ("name", "ids", "_t0", "_range", "_ns", "_parent")

    def __init__(self, name: str, **ids: int):
        self.name = name
        self.ids = ids

    def __enter__(self) -> "span":
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._ns = time.time_ns()
            names = getattr(_open, "names", None)
            if names is None:
                names = _open.names = []
            self._parent = names[-1] if names else None
            names.append(self.name)
            self._range = _RecordFunctionFast(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        seconds = time.perf_counter() - self._t0
        interval = None
        if self._range is not None:
            self._range.__exit__(*exc)
            _open.names.pop()
            interval = (self.name, self._ns, time.time_ns(), threading.get_ident(),
                        self._parent, self.ids)
        global _dropped
        with _lock:
            entry = _totals.get(self.name)
            if entry is None:
                _totals[self.name] = [1, seconds]
            else:
                entry[0] += 1
                entry[1] += seconds
            if interval is not None:
                if len(_intervals) < MAX_INTERVALS:
                    _intervals.append(interval)
                else:
                    _dropped += 1


def totals() -> Dict[str, Tuple[int, float]]:
    """Every span so far, profiled or not: ``{name: (count, host seconds)}``."""
    with _lock:
        return {name: (int(n), s) for name, (n, s) in _totals.items()}


def intervals() -> List[Interval]:
    """The intervals of the spans that closed while a profiler collected,
    in the order they closed (at most ``MAX_INTERVALS``)."""
    with _lock:
        return list(_intervals)


def dropped() -> int:
    """Intervals not kept since the last :func:`reset`: the list was full."""
    return _dropped


def reset() -> None:
    """Clear the intervals and the count of dropped ones (not the totals)."""
    global _dropped
    with _lock:
        _intervals.clear()
        _dropped = 0
