"""backbone_ms.slide: in the Rein + Mask2Former slide cell, the device time
of the profiled span whose innermost program range is ``vfmseg.backbone``
(the Rein DINOv2 over a frame's crops: its blocks, the adapters, the
pyramid and the query vector), in ms an image (``spans.phase_ms``). Moves
``dense_images_per_s``."""

from cardbench import spans


def read(r):
    return spans.phase_ms(r, "vfmseg.backbone")
