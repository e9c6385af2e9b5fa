"""Host milliseconds of one occurrence of a span of the program.

``span_ms.<span>.<cell>``, the span's name with ``_`` for its first ``.``
(``span_ms.data_wait.vocoder`` reads ``data.wait``): the program's
intervals (``utils/profiling.py:intervals``, kept while the traced
window's profiler collects) that start inside the window, each clipped to
the window's end, their mean length. Nothing is read where the program
keeps no intervals or none of the span starts in the window.
"""

from ..lib import spans


def read(name, run):
    summary = run.summary
    if summary is None:
        return None
    lo, hi = summary.window
    lengths = [min(end, hi) - start for start, end in spans.intervals(spans.metric_span(name))
               if lo <= start < hi]
    if not lengths:
        return None
    return sum(lengths) / len(lengths) / 1e6
