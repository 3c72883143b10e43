"""peak_mem_gib.dense: in the per-image dense cells, ``torch.cuda.max_memory_allocated`` over
the window, in GiB; None off the card. Moves ``dense_images_per_s``."""

from cardbench.readers import peak_gib as read  # noqa: F401
