"""Share of the traced window in which the card was idle under a span of the program.

``idle_under.<span>.<cell>`` (the span's name as ``span_ms`` writes it):
the time, over the window's length, in which no kernel, copy or fill ran
on the card while the span was open on any host thread. The device's busy
time is the union of its operations as ``lib/trace.py`` takes it, the
span's the union of its intervals (``utils/profiling.py:intervals``), both
clipped to the window. Nothing is read where the program keeps no
intervals of the span in the window.
"""

from ..lib import spans
from ..lib.trace import _union


def _length(ivs):
    return sum(b - a for a, b in ivs)


def _overlap(a, b):
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(name, run):
    summary = run.summary
    if summary is None or summary.window_s <= 0:
        return None
    open_ = _union(spans.intervals(spans.metric_span(name)), summary.window)
    if not open_:
        return None
    busy = _union([iv for ivs in summary.kernels.values() for iv in ivs], summary.window)
    idle_ns = _length(open_) - _overlap(open_, busy)
    return 100.0 * idle_ns / (summary.window[1] - summary.window[0])
