"""mfu.dense: in the per-image dense cells, the model FLOPs of the images completed in the
window over the window's seconds and the card's bf16 peak, in percent
(``readers.frames_mfu``: stage 1 and the windows the gate sends on, never
the work a path discards). Moves ``dense_images_per_s``."""

from cardbench.readers import frames_mfu as read  # noqa: F401
