"""hr_forward_ms.stream: in the compact stream cells, the device time of
the profiled span whose innermost program range is ``vfmseg.hr_forward``
(the backbone and VFMHead over the windows the gate sends on, bucket
padding included), in ms an image of the span (``spans.phase_ms``). Moves
``images_per_s``."""

from cardbench import spans


def read(r):
    return spans.phase_ms(r, "vfmseg.hr_forward")
