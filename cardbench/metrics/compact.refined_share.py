"""compact.refined_share: the share of the stream's windows that the gate
sent on to the refine head over the window, in percent, from the compact
engine's counters (``stat_refined / stat_windows``)."""


def read(r):
    c = r.counters
    if not c or not c.get("windows"):
        return None
    return 100.0 * c["refined"] / c["windows"]
