"""pixel_decoder_ms.slide: in the Rein + Mask2Former slide cell, the device
time of the profiled span whose innermost program range is
``vfmseg.pixel_decoder`` (the input projections, the 6 deformable encoder
layers with B8, the FPN and the mask features), in ms an image
(``spans.phase_ms``). Moves ``dense_images_per_s``."""

from cardbench import spans


def read(r):
    return spans.phase_ms(r, "vfmseg.pixel_decoder")
