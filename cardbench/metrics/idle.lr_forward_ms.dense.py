"""idle.lr_forward_ms.dense: in the per-image dense cells, the device's
idle time in the profiled span whose gaps' midpoints lie innermost in the
program range ``vfmseg.lr_forward`` (the host launching stage 1's
forward while the device waits), in ms an image
(``spans.phase_ms(idle=True)``). Moves ``dense_images_per_s``."""

from cardbench import spans


def read(r):
    return spans.phase_ms(r, "vfmseg.lr_forward", idle=True)
