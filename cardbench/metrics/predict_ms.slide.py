"""predict_ms.slide: in the Rein + Mask2Former slide cell, the device time
of the profiled span whose innermost program range is ``vfmseg.predict``
(the crops, each crop's logits resized to 512 x 512, the overlap average,
the resize to the frame and the argmax), in ms an image
(``spans.phase_ms``). Moves ``dense_images_per_s``."""

from cardbench import spans


def read(r):
    return spans.phase_ms(r, "vfmseg.predict")
