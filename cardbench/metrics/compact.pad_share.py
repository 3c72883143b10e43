"""compact.pad_share: the share of the refine head's rows that were bucket
padding over the window, in percent, from the compact engine's counters
(``(stat_refine_rows - stat_refined) / stat_refine_rows``)."""


def read(r):
    c = r.counters
    if not c or not c.get("refine_rows"):
        return None
    return 100.0 * (c["refine_rows"] - c["refined"]) / c["refine_rows"]
