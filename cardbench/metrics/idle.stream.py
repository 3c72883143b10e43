"""idle.stream: in the compact stream's cells, the share of the profiled span in which the device
ran nothing, in percent (``readers.idle``). Moves ``images_per_s``."""

from cardbench.readers import idle as read  # noqa: F401
