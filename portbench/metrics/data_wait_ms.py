"""Host milliseconds a training step waits on its data, on the harness's clock.

The time the loop spends in ``bench.assemble`` (taking batches from the
prefetch loader; for CPC also drawing the negatives) per step, over the
window.
"""


def read(name, run):
    steps = run.counters.get("steps")
    if not steps:
        return None
    return 1e3 * run.counters["data_wait_s"] / steps
