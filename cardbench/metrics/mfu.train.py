"""mfu.train: the reckoned FLOPs of the steps completed in the window
(``counters.train_step_flops``: the forward and the backward the step
needs) over the window's seconds and the card's bf16 peak, in percent."""

from cardbench import counters


def read(r):
    if not r.steps or r.window_s <= 0:
        return None
    flops = r.steps * counters.train_step_flops(
        r.config, int(r.mix["batch_size"]), tuple(r.mix["crop_hw"]))
    return 100.0 * flops / (r.window_s * counters.PEAK_BF16_FLOPS)
