"""dense_images_per_s: in the per-image dense cells, every image completed
in the window over the window's seconds, the window synchronised on the
device at both ends (one client, so the host's pace shows here)."""

from cardbench import readers


def read(r):
    return readers.rate(r.images, r.window_s)
