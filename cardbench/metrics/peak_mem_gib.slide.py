"""peak_mem_gib.slide: in the Rein + Mask2Former slide cell,
``torch.cuda.max_memory_allocated`` over the window, in GiB; None off the
card. Moves ``dense_images_per_s``."""

from cardbench.readers import peak_gib as read  # noqa: F401
