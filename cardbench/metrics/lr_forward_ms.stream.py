"""lr_forward_ms.stream: in the compact stream cells, the device time of
the profiled span whose innermost program range is ``vfmseg.lr_forward``
(the backbone and LinearHead over each group at stage 1's size), in ms an
image of the span (``spans.phase_ms``). Moves ``images_per_s``."""

from cardbench import spans


def read(r):
    return spans.phase_ms(r, "vfmseg.lr_forward")
