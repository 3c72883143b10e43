"""peak_mem_gib.stream: in the compact stream's cells, ``torch.cuda.max_memory_allocated`` over
the window, in GiB; None off the card. Moves ``images_per_s``."""

from cardbench.readers import peak_gib as read  # noqa: F401
