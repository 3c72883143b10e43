"""Convert EVA02-L torch checkpoints into the backbone param tree.

Port of tools/convert_eva2.py (the JAX package's) with the same key
mapping: the RoPE buffers are dropped (the tables are rebuilt per input
size), the patch-embed kernel resized 14 -> 16 and the position grid to
(512 / 16)^2, split q/k/v projections (k has no bias; ``q_bias``/``v_bias``
are parameters of their own), the SwiGLU's w1/w2/ffn_ln/w3, and LayerScale
where the checkpoint has it. Output in the JAX package's ``.npz`` layout::

    python -m vfmseg_tpu_torch.tools.convert_eva2 \\
        eva02_L_pt_m38m_p14.pt eva02_converted.npz
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

from vfmseg_tpu_torch.tools.convert_dinov2 import (
    _resize_patch_kernel,
    _resize_pos_embed,
    cli,
    tree_builder,
)

# torch name in a block -> (flax path, transpose)
BLOCK_MAP = {
    "norm1.weight": ("norm1/scale", False),
    "norm1.bias": ("norm1/bias", False),
    "norm2.weight": ("norm2/scale", False),
    "norm2.bias": ("norm2/bias", False),
    "attn.q_proj.weight": ("attn/q_proj/kernel", True),
    "attn.k_proj.weight": ("attn/k_proj/kernel", True),
    "attn.v_proj.weight": ("attn/v_proj/kernel", True),
    "attn.q_bias": ("attn/q_proj/bias", False),
    "attn.v_bias": ("attn/v_proj/bias", False),
    "attn.proj.weight": ("attn/proj/kernel", True),
    "attn.proj.bias": ("attn/proj/bias", False),
    "mlp.w1.weight": ("mlp/w1/kernel", True),
    "mlp.w1.bias": ("mlp/w1/bias", False),
    "mlp.w2.weight": ("mlp/w2/kernel", True),
    "mlp.w2.bias": ("mlp/w2/bias", False),
    "mlp.w3.weight": ("mlp/w3/kernel", True),
    "mlp.w3.bias": ("mlp/w3/bias", False),
    "mlp.ffn_ln.weight": ("mlp/ffn_ln/scale", False),
    "mlp.ffn_ln.bias": ("mlp/ffn_ln/bias", False),
    "gamma_1": ("ls1/gamma", False),
    "gamma_2": ("ls2/gamma", False),
}


def convert_eva02_state_dict(sd: Dict[str, np.ndarray],
                             target_patch: int = 16,
                             target_img: int = 512) -> dict:
    out, put = tree_builder()
    put("cls_token", sd["cls_token"])
    put("pos_embed",
        _resize_pos_embed(sd["pos_embed"], target_img // target_patch))
    pk = _resize_patch_kernel(sd["patch_embed.proj.weight"], target_patch)
    put("patch_embed/kernel", pk.transpose(2, 3, 1, 0))
    put("patch_embed/bias", sd["patch_embed.proj.bias"])

    blk = re.compile(r"^blocks\.(\d+)\.(.+)$")
    for key, val in sd.items():
        m = blk.match(key)
        if not m or m.group(2) not in BLOCK_MAP:
            continue  # the rope tables among them
        fpath, transpose = BLOCK_MAP[m.group(2)]
        put(f"blocks_{int(m.group(1))}/{fpath}", val.T if transpose else val)
    return out


def main(argv=None) -> None:
    cli("Convert an EVA02 checkpoint", convert_eva02_state_dict,
        ("state_dict", "module", "model"), argv=argv)


if __name__ == "__main__":
    main()
