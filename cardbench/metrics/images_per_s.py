"""images_per_s: in the compact stream's cells, every image completed in
the window over the window's seconds, the window synchronised on the device
at both ends."""

from cardbench import readers


def read(r):
    return readers.rate(r.images, r.window_s)
