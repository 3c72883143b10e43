"""image_latency_p95_ms: the 95th percentile of every image's latency in
the window (one client, a closed loop; each from the call to the labels
synchronised on the device). None where the loop times no single image."""

import numpy as np


def read(r):
    if not r.latencies_s:
        return None
    return float(np.percentile(np.asarray(r.latencies_s), 95)) * 1e3
