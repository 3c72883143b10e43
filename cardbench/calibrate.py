"""The gate's operating point: the decode head's logit scale at which the
gate skips a target share of a pool's windows.

With seeded weights the stage-1 logits are unconfident and the gate would
send every window on; a trained model skips most. The stage-1 logits are
linear in the decode head's classifier, so scaling its weight and bias by
``s`` scales them. So one pass of the program's stage 1 over the pool at
scale 1 gives the logits at any scale ``s`` as ``s`` times them, up to
rounding: the scale is bracketed by factors of 8 from [1e-3, 1], then
bisected on the skip share of those scaled logits. Rounding (the scaled
classifier is held in bfloat16) moves a few windows that lie at the
threshold, so the bisection ends on passes of the program itself, in a
bracket of a few percent around that scale. The target is a whole number
of windows, the nearest to the share asked for, so that every seed skips
the same number of the pool's windows. The result belongs to the weights:
both the program and the reference take the scaled classifier.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

# steps of the final bisection on passes of the program (after its two ends)
PASSES = 12


def skip_share(shares: List[torch.Tensor], conf: float) -> float:
    """The share of windows whose confident share reaches ``conf``."""
    skips = sum(int((c >= conf).sum()) for c in shares)
    return skips / sum(c.numel() for c in shares)


def bisect(measured: Callable[[float], float], target: float,
           tolerance: float, lo: float = 1e-3, hi: float = 1.0,
           steps: int = 48) -> float:
    """The scale whose ``measured`` skip share lies nearest ``target``,
    from the bracket [``lo``, ``hi``] widened by factors of 8 until it
    holds the target."""
    while measured(hi) < target and hi < 1e9:
        lo, hi = hi, hi * 8.0
    while measured(lo) > target and lo > 1e-9:
        lo, hi = lo / 8.0, lo
    best, best_r = hi, measured(hi)
    for _ in range(steps):
        mid = float(np.sqrt(lo * hi))
        r = measured(mid)
        if abs(r - target) < abs(best_r - target):
            best, best_r = mid, r
        if abs(r - target) <= tolerance:
            break
        lo, hi = (mid, hi) if r < target else (lo, mid)
    return best


def calibrate(logits_at: Callable[[float], List[torch.Tensor]],
              shares_of: Callable[[torch.Tensor, float], torch.Tensor],
              conf: float, target: float) -> Tuple[float, float, List[int]]:
    """(scale, measured skip share, refined windows of each frame).

    ``logits_at(s)`` runs the program's stage 1 at scale ``s`` over the
    pool, a batch at a time; ``shares_of(logits, k)`` is a batch's window
    shares of ``k`` times its logits, as [windows, images]."""
    logits = logits_at(1.0)
    windows = sum(shares_of(lg, 1.0).numel() for lg in logits)
    want = round(target * windows) / windows
    tolerance = 0.5 / windows
    guess = bisect(lambda t: skip_share([shares_of(lg, t) for lg in logits],
                                        conf), want, tolerance)
    del logits
    seen = {}

    def exact(s: float) -> float:
        if s not in seen:
            shares = [shares_of(lg, 1.0) for lg in logits_at(s)]
            seen[s] = (skip_share(shares, conf), shares)
        return seen[s][0]

    bisect(exact, want, tolerance, guess / 1.02, guess * 1.02, steps=PASSES)
    s = min(seen, key=lambda x: abs(seen[x][0] - want))
    r, shares = seen[s]
    refined = []
    for c in shares:
        refined.extend(int(x) for x in (c < conf).sum(dim=0).tolist())
    return s, r, refined
