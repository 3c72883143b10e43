"""train_steps_per_s: every optimizer step completed in the window over
the window's seconds, the window synchronised on the device at both
ends."""

from cardbench import readers


def read(r):
    return readers.rate(r.steps, r.window_s)
