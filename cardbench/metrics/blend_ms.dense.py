"""blend_ms.dense: in the per-image dense cells, the device time of the
profiled span whose innermost program range is ``vfmseg.refine`` (the
select and the overlap average; not the forward), in ms an image
(``spans.phase_ms``). Moves ``dense_images_per_s``."""

from cardbench import spans


def read(r):
    return spans.phase_ms(r, "vfmseg.refine")
