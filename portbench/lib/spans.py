"""The program's own spans, as ``utils/profiling.py`` keeps them.

While a profiler collects, the program keeps an interval for each of its
spans (``serving.*``, ``data.*``, ``step.*``), stamped on the clock of the
profiler's events, so they sit on the traced window's clock. A program
that keeps none (no ``intervals`` there) gives none here.
"""

from typing import List, Tuple


def intervals(name: str) -> List[Tuple[int, int]]:
    """(start_ns, end_ns) of every kept interval of the span ``name``."""
    from vectorquantizedcpc_tpu_torch.utils import profiling

    kept = getattr(profiling, "intervals", None)
    if kept is None:
        return []
    return [(iv[1], iv[2]) for iv in kept() if iv[0] == name]


def metric_span(metric: str) -> str:
    """The span a metric ``<family>.<span>.<cell>`` reads: its middle part
    with its first ``_`` for ``.`` (``data_wait`` is ``data.wait``)."""
    return metric.split(".")[1].replace("_", ".", 1)
