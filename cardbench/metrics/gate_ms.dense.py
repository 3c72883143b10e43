"""gate_ms.dense: in the per-image dense cells, the device time of the
profiled span whose innermost program range is ``vfmseg.stage1`` (the LR
resize, the upsample to frame size, the crops' extraction and the
windows' confidences; not the forward), in ms an image
(``spans.phase_ms``). Moves ``dense_images_per_s``."""

from cardbench import spans


def read(r):
    return spans.phase_ms(r, "vfmseg.stage1")
