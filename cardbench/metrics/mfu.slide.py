"""mfu.slide: in the Rein + Mask2Former slide cell, the reckoned FLOPs of
the images completed in the window (``counters_rein_m2f.image_flops``: the
frame's crops through the ViT, Rein, the pixel decoder, the decoder and the
semantic inference) over the window's seconds and the card's bf16 peak, in
percent. Moves ``dense_images_per_s``."""

from cardbench import counters, counters_rein_m2f


def read(r):
    if r.window_s <= 0 or not r.images:
        return None
    flops = r.images * counters_rein_m2f.image_flops(
        r.config, tuple(r.mix["frame_hw"]))
    return 100.0 * flops / (r.window_s * counters.PEAK_BF16_FLOPS)
