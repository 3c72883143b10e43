"""gate_ms.stream: in the compact stream cells, the device time of the
profiled span whose innermost program range is ``vfmseg.stage1`` (the
group's stack, the input resize, the upsample to frame size, the confident
mask, the window shares and the readback copy; not the forward), in ms an
image of the span (``spans.phase_ms``). Moves ``images_per_s``."""

from cardbench import spans


def read(r):
    return spans.phase_ms(r, "vfmseg.stage1")
