"""attention_roofline.stream: in the compact stream's cells, the least time the card could take
for the attention the profiled span's images need (the ViT's blocks at
stage 1 and over the windows the gate sends on, and the decoder's self- and
cross-attention of those windows) over the device time of the attention
kernels, in percent. Matched by name: B2 (``attention_qkv_kernel``) and
B2-RoPE's rotation pass (``rope_rotate_kernel``). None where no such
kernel ran. Moves ``images_per_s``."""

from cardbench import readers

PATTERNS = ("attention_qkv_kernel", "rope_rotate_kernel")


def read(r):
    return readers.frames_roofline(r, PATTERNS)
