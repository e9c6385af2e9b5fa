"""Host milliseconds the server spends in a segment step (``ContinuousBatcher.stats``).

``dispatch_wall_s / steps`` over the window: admission, conditioning,
launch and retirement on the host, per segment launched (the planned
drain counts its whole pass, per segment it launched).
"""


def read(name, run):
    stats = run.counters.get("stats_window")
    if not stats or not stats.get("steps"):
        return None
    return 1e3 * stats["dispatch_wall_s"] / stats["steps"]
