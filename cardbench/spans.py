"""The program's ranges in a traced span, and the device's busy and idle
time split among them.

The program marks its phases with ranges named ``vfmseg.<phase>``, or
``vfmseg.<phase>#<group>`` in the compact stream
(``vfmseg_tpu_torch/utils/profiling.py`` ``span``). They are
function-scope records, which the Chrome trace files as ``cpu_op``, so
``Trace.host`` holds them beside the operators and runtime calls, on the
clock of the kernels. A phase is the name before ``#``.

* Each kernel and copy belongs to the innermost program range whose host
  interval holds the call that launched it, else to ``outside``. ``Trace``
  keeps no correlation ids, so launch calls and device ops of one kind are
  paired in order: the program queues its work on one stream, which runs
  it in the order it was launched. They are paired from the span's end:
  the profiler loses the records of the first few kernels a span launches
  (0-3 of 5,000-11,000 in each of ten traces of the five cells on an
  H100), never their launch calls. On those traces this pairing gave every
  op the launch its correlation id names. It is given up where a kind has
  more ops than calls, and the device times then read nothing. (An op's
  start is no check: the trace put some ops up to 0.9 ms before their
  launch.)
* A memset belongs where the next kernel on the stream does: it clears a
  buffer for that kernel (cuBLAS's workspace, a zeroed output), and some
  of cuBLAS's memset calls put nothing on the stream.
* An op adds the time no earlier op covers (the union ``busy_s`` is), so
  the phases and ``outside`` sum to ``busy_s``.
* Each idle gap of the device belongs to the innermost program range that
  holds the gap's midpoint, the rule ``Trace.idle_gaps`` names gaps by.
"""

from __future__ import annotations

import bisect
import functools
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

PREFIX = "vfmseg."
OUTSIDE = "outside"
# CUDA runtime and driver-API calls that put one kernel or copy on a stream,
# and the names that start a copy's and a memset's record in the trace
KERNEL_CALLS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel",
                "cuLaunchKernel", "cuLaunchCooperativeKernel")
COPY_CALLS = ("cudaMemcpy", "cuMemcpy")
COPY, MEMSET = "Memcpy", "Memset"


def phase(name: str) -> str:
    return name.split("#", 1)[0]


def _outermost(calls: List[Tuple[float, float, str]]):
    """The calls not nested in another one (a runtime call's own driver
    call is one launch)."""
    out = []
    for a, b, name in sorted(calls, key=lambda c: (c[0], -c[1])):
        if out and b <= out[-1][1]:
            continue
        out.append((a, b, name))
    return out


def _paired(ops, calls) -> Optional[List[float]]:
    """Each op's launch time, ops and calls paired in order from the end;
    None where there are more ops than calls."""
    d = len(calls) - len(ops)
    return None if d < 0 else [a for a, _, _ in calls[d:]]


class Program:
    """The program's ranges of a ``Trace`` and what the device did in
    them, in seconds by phase: ``device_s`` (None where launches and ops
    could not be paired) and ``idle_s``."""

    def __init__(self, trace):
        self.ranges = sorted((a, b, n) for a, b, n in trace.host
                             if n.startswith(PREFIX))
        self.phases = {phase(n) for _, _, n in self.ranges}
        self._starts = [a for a, _, _ in self.ranges]
        calls = _outermost([h for h in trace.host
                            if h[2].startswith(KERNEL_CALLS + COPY_CALLS)])
        ops = sorted(trace.kernels)
        kernels = [i for i, o in enumerate(ops)
                   if not o[2].startswith((COPY, MEMSET))]
        copies = [i for i, o in enumerate(ops) if o[2].startswith(COPY)]
        k_at = _paired([ops[i] for i in kernels],
                       [c for c in calls if c[2].startswith(KERNEL_CALLS)])
        c_at = _paired([ops[i] for i in copies],
                       [c for c in calls if c[2].startswith(COPY_CALLS)])
        self.device_s: Optional[Dict[str, float]] = None
        if k_at is not None and c_at is not None:
            at = dict(zip(kernels + copies, k_at + c_at))
            # backwards, so a memset takes the next kernel's phase
            owner, where = [OUTSIDE] * len(ops), OUTSIDE
            for i in range(len(ops) - 1, -1, -1):
                if i in at:
                    where = self.innermost(at[i])
                owner[i] = where
            self.device_s = defaultdict(float)
            covered = float("-inf")
            for (a, b, _), who in zip(ops, owner):
                added = b - max(a, covered)
                covered = max(covered, b)
                if added > 0:
                    self.device_s[who] += added * 1e-6
        self.idle_s: Dict[str, float] = defaultdict(float)
        for a, b in trace.gaps:
            self.idle_s[self.innermost(0.5 * (a + b))] += (b - a) * 1e-6

    def innermost(self, t: float) -> str:
        """The phase of the innermost range holding ``t``: ranges nest, so
        it is the latest-starting one still open at ``t``."""
        i = bisect.bisect_right(self._starts, t) - 1
        for j in range(i, -1, -1):
            if self.ranges[j][1] >= t:
                return phase(self.ranges[j][2])
        return OUTSIDE


@functools.lru_cache(maxsize=1)
def program(trace) -> Program:
    return Program(trace)


def phase_ms(r, name: str, idle: bool = False) -> Optional[float]:
    """The device time (or with ``idle`` the device's idle time) that went
    to phase ``name`` in the profiled span, in ms an image of the span.
    None where the span ran nothing on a device, holds no range of that
    phase, or (device time) its launches could not be paired."""
    t = r.trace
    if t is None or not t.kernels or not r.span_frames:
        return None
    p = program(t)
    table = p.idle_s if idle else p.device_s
    if name not in p.phases or table is None:
        return None
    return 1e3 * table.get(name, 0.0) / len(r.span_frames)
