"""Profiling and debugging helpers.

Port of vfmseg_tpu/utils/profiling.py on PyTorch:

* :func:`trace`: a ``torch.profiler`` trace of the enclosed code, CPU and
  (where there is one) CUDA activity, written as a Chrome trace
  (``trace.json``, open in Perfetto or ``chrome://tracing``) under
  ``logdir``; the JAX helper writes a TensorBoard trace;
* :func:`enable_nan_debugging`: ``torch.autograd.set_detect_anomaly``,
  which raises where a backward function returns NaN and names the
  forward op that made it. It checks the backward only: ``jax_debug_nans``
  checks the output of every op, forward included;
* :class:`StepTimer`: the steps/s and images/s meter, as in the JAX
  package.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed code into ``<logdir>/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def enable_nan_debugging(enable: bool = True) -> None:
    """Turn autograd's anomaly detection on or off (NaN checks of the
    backward, with the forward op's trace). Slows training; for debugging
    only."""
    torch.autograd.set_detect_anomaly(enable, check_nan=True)


class StepTimer:
    """Streaming steps/sec + images/sec meter."""

    def __init__(self, batch_size: int = 1, window: int = 50):
        self.batch_size = batch_size
        self.window = window
        self._t0: Optional[float] = None
        self._count = 0

    def tick(self) -> Optional[dict]:
        now = time.time()
        if self._t0 is None:
            self._t0 = now
            return None
        self._count += 1
        if self._count % self.window:
            return None
        dt = now - self._t0
        self._t0 = now
        steps_per_sec = self.window / max(dt, 1e-9)
        return {
            "steps_per_sec": steps_per_sec,
            "images_per_sec": steps_per_sec * self.batch_size,
        }
