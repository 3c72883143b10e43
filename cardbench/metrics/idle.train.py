"""idle.train: the share of the profiled steps' span in which the device
ran nothing, in percent (``readers.idle``). Moves ``train_steps_per_s``."""

from cardbench.readers import idle as read  # noqa: F401
