"""Profiling and debugging helpers.

Port of vfmseg_tpu/utils/profiling.py on PyTorch:

* :func:`trace`: a ``torch.profiler`` trace of the enclosed code, CPU and
  (where there is one) CUDA activity, written as a Chrome trace
  (``trace.json``, open in Perfetto or ``chrome://tracing``) under
  ``logdir``; the JAX helper writes a TensorBoard trace. The trace carries
  the program's ranges (:func:`span`) beside the kernels they launched;
* :func:`span`: a named range of the program in a running profiler's
  trace, and one flag read when no profiler runs;
* :func:`enable_nan_debugging`: ``torch.autograd.set_detect_anomaly``,
  which raises where a backward function returns NaN and names the
  forward op that made it. It checks the backward only: ``jax_debug_nans``
  checks the output of every op, forward included.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

# the context ``span`` hands out while no profiler runs
_OFF = contextlib.nullcontext()


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


def span(name: str):
    """A context manager that marks the enclosed code as the range ``name``
    in the trace of a running ``torch.profiler`` profile, on the clock of
    the kernels it launches; with no profiler running, a shared no-op
    context, decided by one flag read.

    The range is a function-scope record (category ``cpu_op`` in the Chrome
    trace, like an operator), so it nests with the operators and runtime
    calls it holds. It adds no device synchronisation. Never hold one open
    across a ``yield``: the range would time the caller."""
    if _autograd_profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _OFF


def enable_nan_debugging(enable: bool = True) -> None:
    """Turn autograd's anomaly detection on or off (NaN checks of the
    backward, with the forward op's trace). Slows training; for debugging
    only."""
    torch.autograd.set_detect_anomaly(enable, check_nan=True)
