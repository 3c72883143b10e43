"""blend_ms.stream: in the compact stream cells, the device time of the
profiled span whose innermost program range is ``vfmseg.refine`` (the
fp32 base, the window choice, the gathers, the deltas and B9; not the
forward), in ms an image of the span (``spans.phase_ms``). Moves
``images_per_s``."""

from cardbench import spans


def read(r):
    return spans.phase_ms(r, "vfmseg.refine")
