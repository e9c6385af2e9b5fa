"""The traced window: ``torch.profiler`` over a few seconds of the measured loop.

The driver opens the window at a fixed offset into its measurement and
closes it some seconds later, both between two iterations of its loop and
each after a ``synchronize``, so the trace holds whole iterations and the
device work they queued. Spans are the harness's own ``record_function``
ranges named ``bench.*``; ``bench.window`` brackets the whole traced
window. The summary reads the profiler's raw events once:

- device intervals: every kernel, copy and fill on the card (the GPU-side
  copies of user ranges are not work and are left out);
- ``busy_s``: the length of the union of those intervals inside the
  window; ``window_s``: the window's length;
- ``kernels``: each device operation's name with its intervals;
- ``idle_gaps``: the gaps of that union, each named by the innermost
  ``bench.*`` span open on the host when the gap began.
"""

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

Interval = Tuple[int, int]


class TraceSummary:
    def __init__(self, window: Interval, device_ops: Dict[str, List[Interval]],
                 spans: List[Tuple[str, int, int]]):
        self.window = window
        self.kernels = device_ops
        self.spans = spans
        merged = _union([iv for ivs in device_ops.values() for iv in ivs], window)
        self.busy_ns = sum(b - a for a, b in merged)
        self._merged = merged

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9

    def kernel_seconds(self, patterns) -> Tuple[float, int]:
        """(seconds, launches) of the device operations whose name holds
        one of ``patterns``, inside the window."""
        total, count = 0, 0
        for name, ivs in self.kernels.items():
            if any(p in name for p in patterns):
                for a, b in _clip(ivs, self.window):
                    total += b - a
                    count += 1
        return total / 1e9, count

    def top_ops(self, n: int = 10) -> List[list]:
        sums = {name: sum(b - a for a, b in _clip(ivs, self.window))
                for name, ivs in self.kernels.items()}
        return [[name, ns / 1e9] for name, ns in sorted(sums.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        lo, hi = self.window
        gaps, t = [], lo
        for a, b in self._merged:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_span(a), (b - a) / 1e9] for a, b in gaps[:n]]

    def _host_span(self, t: int) -> str:
        best = None
        for name, a, b in self.spans:
            if name != "bench.window" and a <= t < b and (best is None or a >= best[1]):
                best = (name, a)
        return best[0] if best else "outside bench spans"


def _clip(ivs, window):
    lo, hi = window
    return [(max(a, lo), min(b, hi)) for a, b in ivs if b > lo and a < hi]


def _union(ivs, window) -> List[Interval]:
    out: List[list] = []
    for a, b in sorted(_clip(ivs, window)):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(prof) -> Optional[TraceSummary]:
    """A finished profile -> its summary, or None where it holds no window."""
    from torch.autograd import DeviceType

    device_ops: Dict[str, List[Interval]] = {}
    spans, window = [], None
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or name.startswith("bench."):
                continue
            device_ops.setdefault(name, []).append((start, end))
        elif e.is_user_annotation() and name.startswith("bench."):
            if name == "bench.window":
                window = (start, end)
            spans.append((name, start, end))
    if window is None:
        return None
    return TraceSummary(window, device_ops, spans)


class Tracer:
    """Profiles the driver's loop from ``start_s`` after the window opened
    for ``length_s`` (counted from the synchronize that opens the trace);
    does nothing where the run is not traced."""

    def __init__(self, enabled: bool, device, start_s: float, length_s: float):
        self.enabled = enabled and torch.device(device).type == "cuda"
        self.device = device
        self.start_s, self.length_s = start_s, length_s
        self._opened = 0.0
        self.summary: Optional[TraceSummary] = None
        self.active = False
        self._stack: Optional[contextlib.ExitStack] = None
        self._prof = None

    def tick(self, elapsed_s: float) -> None:
        """Call between iterations with the seconds since the window opened."""
        if not self.enabled:
            return
        if not self.active and self.summary is None and elapsed_s >= self.start_s:
            self._open()
        elif self.active and time.perf_counter() - self._opened >= self.length_s:
            self.close()

    def _open(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize(self.device)
        self._stack = contextlib.ExitStack()
        self._prof = self._stack.enter_context(
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        self._stack.enter_context(record_function("bench.window"))
        self._opened = time.perf_counter()
        self.active = True

    def close(self) -> None:
        if not self.active:
            return
        torch.cuda.synchronize(self.device)
        self._stack.close()
        self.active = False
        self.summary = summarize(self._prof)
        self._prof = None
