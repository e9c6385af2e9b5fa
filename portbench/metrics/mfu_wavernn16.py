"""Model FLOPs per second of the dual softmax vocoder in the traced window over the bf16 peak.

``mfu_wavernn16.serve_batch``: the 16-bit samples the server put out in
the traced window (``stats["samples_out"]``) times the model FLOPs of
converting one (``portbench/roofline/wavernn16.py``), over the window's
length and 989 TFLOP/s (``roofline/peaks.py``), as ``mfu.py`` counts the
RNN_MS cells.
"""

from ..roofline import models, peaks, wavernn16


def read(name, run):
    summary = run.summary
    if name != "mfu_wavernn16.serve_batch" or summary is None or summary.window_s <= 0:
        return None
    traced = run.counters.get("stats_traced")
    if not traced:
        return None
    flops = traced["samples_out"] * wavernn16.served_per_sample(models.widths(run.counters["conf"]))
    if flops <= 0:
        return None
    return 100.0 * flops / summary.window_s / peaks.BF16_FLOPS
