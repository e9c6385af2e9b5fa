"""A kernel's share of its roofline, from the device trace.

``roofline.<kernel>[.<cell>]``: the least time the card could take for
the calls the driver queued in the traced window (``portbench/roofline/
<kernel>.py``, from each call's shapes) over the time the trace shows the
kernel's launches running. Nothing is read where the trace holds no launch
of the kernel or a different count of them than the calls account for.
"""

import importlib


def read(name, run):
    kernel = name.split(".")[1]
    calls = run.calls.get(kernel)
    summary = run.summary
    if not calls or summary is None:
        return None
    mod = importlib.import_module(f"portbench.roofline.{kernel}")
    seconds, launches = summary.kernel_seconds(mod.KERNELS)
    if seconds <= 0 or launches != len(calls) * mod.LAUNCHES_PER_CALL:
        return None
    return 100.0 * sum(mod.least(c) for c in calls) / seconds
