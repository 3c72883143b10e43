"""deform_roofline.slide: in the Rein + Mask2Former slide cell, the least
time the card could take for the profiled span's B8 calls (their bytes at
3.35 TB/s, ``counters_rein_m2f.deform_bound_s``) over the device time of
the kernels named ``deform_sample_kernel``, in percent. None where no such
kernel ran. Moves ``dense_images_per_s``."""

from cardbench import counters_rein_m2f

PATTERNS = ("deform_sample_kernel",)


def read(r):
    t = r.trace
    if t is None or not r.span_frames:
        return None
    spent = t.kernel_s(PATTERNS)
    if spent <= 0:
        return None
    hw = tuple(r.mix["frame_hw"])
    need = len(r.span_frames) * counters_rein_m2f.deform_bound_s(r.config, hw)
    return 100.0 * need / spent
