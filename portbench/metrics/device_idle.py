"""Share of the traced window in which nothing ran on the card.

One minus the union of every kernel, copy and fill interval over the
window's length (``busy_s / window_s``), so overlapping work counts once.
"""


def read(name, run):
    summary = run.summary
    if summary is None or summary.window_s <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
