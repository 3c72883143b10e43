"""idle.slide: in the Rein + Mask2Former slide cell, the share of the
profiled span in which the device ran nothing, in percent
(``readers.idle``). Moves ``dense_images_per_s``."""

from cardbench.readers import idle as read  # noqa: F401
