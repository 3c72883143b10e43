"""attention_roofline.slide: in the Rein + Mask2Former slide cell, the
least time the card could take for the ViT attention of the profiled
span's images (every block over the frame's crops,
``counters_rein_m2f.attention_bound_s``) over the device time of the
kernels named ``attention_qkv_kernel`` (B2), in percent. None where no
such kernel ran. Moves ``dense_images_per_s``."""

from cardbench import counters_rein_m2f

PATTERNS = ("attention_qkv_kernel",)


def read(r):
    t = r.trace
    if t is None or not r.span_frames:
        return None
    spent = t.kernel_s(PATTERNS)
    if spent <= 0:
        return None
    hw = tuple(r.mix["frame_hw"])
    need = len(r.span_frames) * counters_rein_m2f.attention_bound_s(
        r.config, hw)
    return 100.0 * need / spent
