"""Reading a ``torch.profiler`` trace of a short span.

The span is the harness's own ``record_function`` range around work that
ends in a device synchronisation, so every kernel it launched ran inside
it. From the Chrome trace of the profiler:

* ``busy_s``: the union of the device's kernel, copy and memset intervals
  within the span (overlapping kernels count once);
* ``window_s``: the span's length;
* ``kernel_s(patterns)``: the summed duration of the kernels whose name
  contains any of ``patterns`` (a roofline's denominator);
* ``device_ops``: the kernels that took the most time, summed by name;
* ``idle_gaps``: the device's idle time within the span, summed by what the
  host was doing at each gap's middle (the innermost host operation or
  runtime call, else "python").
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
SPAN = "cardbench.span"


class Trace:
    def __init__(self, events: List[Dict]):
        spans = [e for e in events if e.get("name") == SPAN
                 and e.get("cat") == "user_annotation"]
        if not spans:
            raise ValueError(f"the trace has no {SPAN!r} range")
        t0 = float(spans[0]["ts"])
        t1 = t0 + float(spans[0]["dur"])
        self.window_s = (t1 - t0) * 1e-6
        self.kernels = [(max(float(e["ts"]), t0),
                         min(float(e["ts"]) + float(e["dur"]), t1),
                         e["name"])
                        for e in events if e.get("ph") == "X"
                        and e.get("cat") in DEVICE_CATS
                        and float(e["ts"]) < t1
                        and float(e["ts"]) + float(e["dur"]) > t0]
        self.host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"])
                     for e in events if e.get("ph") == "X"
                     and e.get("cat") in HOST_CATS]
        merged = []
        for a, b, _ in sorted(self.kernels):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) * 1e-6
        edges = [t0] + [x for ab in merged for x in ab] + [t1]
        self.gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2])
                     if b > a]

    def kernel_s(self, patterns: Iterable[str]) -> float:
        pats = tuple(patterns)
        return sum(b - a for a, b, name in self.kernels
                   if any(p in name for p in pats)) * 1e-6

    def device_ops(self, top: int = 10) -> List[Tuple[str, float]]:
        by = defaultdict(float)
        for a, b, name in self.kernels:
            by[name[:200]] += (b - a) * 1e-6
        return sorted(by.items(), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        by = defaultdict(float)
        host = sorted(self.host)
        starts = [s for s, _, _ in host]
        for a, b in self.gaps:
            mid = 0.5 * (a + b)
            name = "python"
            # host ranges nest: the innermost one holding ``mid`` is the
            # latest-starting one that still runs at ``mid``
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 256, -1), -1):
                if host[j][1] >= mid:
                    name = host[j][2]
                    break
            by[name[:200]] += (b - a) * 1e-6
        return sorted(by.items(), key=lambda kv: -kv[1])[:top]


def profile(fn) -> Trace:
    """Run ``fn`` (which must end in a device synchronisation) under the
    profiler inside the span range and read its trace; the trace file is
    written under the temporary directory and removed."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SPAN):
            fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return Trace(events)
