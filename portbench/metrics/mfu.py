"""Model FLOPs per second in the traced window over the card's bf16 peak.

The work is counted from the config's widths (``portbench/roofline/
models.py``): for serving, the samples the server put out in the window
times the model FLOPs of converting one; for training, the steps
dispatched in it times a step's. The traced window opens and closes after
a ``synchronize``, so that work ran inside it. Held to 989 TFLOP/s, the
published dense bf16 peak at 700 W; the run prints the card's power limit.
"""

from ..roofline import models, peaks


def read(name, run):
    summary = run.summary
    if summary is None or summary.window_s <= 0:
        return None
    c = run.counters
    w = models.widths(c["conf"])
    if name in ("mfu.serve_open", "mfu.serve_batch"):
        traced = c.get("stats_traced")
        if not traced:
            return None
        flops = traced["samples_out"] * models.served_per_sample(w)
    elif name == "mfu.vocoder":
        flops = c["traced_steps"] * models.vocoder_train_step(w, c["batch"], c["samples"])
    elif name == "mfu.cpc":
        flops = c["traced_steps"] * models.cpc_train_step(w, c["clips"], c["frames"])
    else:
        return None
    if flops <= 0:
        return None
    return 100.0 * flops / summary.window_s / peaks.BF16_FLOPS
