"""mask_decoder_ms.slide: in the Rein + Mask2Former slide cell, the device
time of the profiled span whose innermost program range is
``vfmseg.mask_decoder`` (the level inputs, the masked-attention decoder
layers with their masks, the last prediction, and the semantic
inference), in ms an image (``spans.phase_ms``). Moves
``dense_images_per_s``."""

from cardbench import spans


def read(r):
    return spans.phase_ms(r, "vfmseg.mask_decoder")
