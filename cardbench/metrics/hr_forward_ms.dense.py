"""hr_forward_ms.dense: in the per-image dense cells, the device time of
the profiled span whose innermost program range is ``vfmseg.hr_forward``
(the backbone and VFMHead over all 18 windows), in ms an image
(``spans.phase_ms``). Moves ``dense_images_per_s``."""

from cardbench import spans


def read(r):
    return spans.phase_ms(r, "vfmseg.hr_forward")
