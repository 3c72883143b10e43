"""attention_roofline.train: the least time the card could take for the
attention of the profiled steps (``counters.train_attention_bound_s``: the
ViT's blocks and the decoder's self- and cross-attention, forward with the
LSE and backward) over the device time of the attention kernels, in
percent. Matched by name: B3 (``attention_qkv_kernel``) and B5's fused
backward with its dq rounding (``attention_hm_bwd_kernel``,
``attention_hm_dq_round_kernel``). None where no such kernel ran."""

from cardbench import counters

PATTERNS = ("attention_qkv_kernel", "attention_hm_bwd_kernel",
            "attention_hm_dq_round_kernel")


def read(r):
    t = r.trace
    if t is None or not r.span_steps:
        return None
    spent = t.kernel_s(PATTERNS)
    if spent <= 0:
        return None
    need = r.span_steps * counters.train_attention_bound_s(
        r.config, int(r.mix["batch_size"]))
    return 100.0 * need / spent
