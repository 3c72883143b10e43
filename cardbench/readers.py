"""What the readers of metrics that several cells share compute, each from
a run's readings (``inference.Readings``); a reader returns None where it
finds nothing to read, never 0."""

from __future__ import annotations

from typing import Iterable, Optional

from cardbench import counters


def rate(count: int, window_s: float) -> Optional[float]:
    """Work completed in the window over its seconds."""
    return count / window_s if count and window_s > 0 else None


def frames_mfu(r) -> Optional[float]:
    """The reckoned FLOPs of the images completed in the window (stage 1 and
    the windows the gate sends on for each one's frame,
    ``counters.frames_flops``) over the window's seconds and the card's
    bf16 peak, in percent."""
    if r.window_s <= 0 or not r.frames_done:
        return None
    flops = counters.frames_flops(r.config,
                                  (r.refined[i] for i in r.frames_done))
    return 100.0 * flops / (r.window_s * counters.PEAK_BF16_FLOPS)


def frames_roofline(r, patterns: Iterable[str]) -> Optional[float]:
    """The least time the card could take for the attention the profiled
    span's images need (``counters.frames_attention_bound_s``) over the
    device time of the kernels whose names hold any of ``patterns``, in
    percent."""
    t = r.trace
    if t is None:
        return None
    spent = t.kernel_s(patterns)
    if spent <= 0:
        return None
    need = counters.frames_attention_bound_s(
        r.config, (r.refined[i] for i in r.span_frames))
    return 100.0 * need / spent


def idle(r) -> Optional[float]:
    """The share of the profiled span in which no kernel, copy or memset ran
    on the device, in percent (1 - the union of their intervals over the
    span)."""
    t = r.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def peak_gib(r) -> Optional[float]:
    """``torch.cuda.max_memory_allocated`` over the window, in GiB."""
    return r.peak_bytes / 2 ** 30 if r.peak_bytes else None
