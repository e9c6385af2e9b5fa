"""Share of the decoded slot-samples that belong to a request.

``samples_out / (steps x slots x segment_frames x hop)`` over the window,
from ``ContinuousBatcher.stats``: idle slots and the unused tail of each
request's last segment are the rest.
"""


def read(name, run):
    stats, c = run.counters.get("stats_window"), run.counters
    if not stats or not stats.get("steps"):
        return None
    decoded = stats["steps"] * c["slots"] * c["segment_frames"] * c["hop"]
    return 100.0 * stats["samples_out"] / decoded
