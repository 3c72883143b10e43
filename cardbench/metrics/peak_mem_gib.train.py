"""peak_mem_gib.train: ``torch.cuda.max_memory_allocated`` over the window
of train steps, in GiB; None off the card. Moves ``train_steps_per_s``."""

from cardbench.readers import peak_gib as read  # noqa: F401
