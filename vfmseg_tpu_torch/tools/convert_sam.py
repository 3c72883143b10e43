"""Convert SAM ViT-H checkpoints into the backbone param tree.

Port of tools/convert_sam.py (the JAX package's) with the same key
mapping: keep ``image_encoder.*``, resize the 4-D position grid to
(512 / 16)^2 bicubically (the port's ``ops/resize.py``), keep the rel-pos
tables at their pretraining length (the model resizes them), and map the
MLP's lin1/lin2 to fc1/fc2; SAM's neck is not part of the backbone. Output
in the JAX package's ``.npz`` layout::

    python -m vfmseg_tpu_torch.tools.convert_sam \\
        sam_vit_h_4b8939.pth sam_converted.npz
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

from vfmseg_tpu_torch.tools.convert_dinov2 import _bicubic, cli, tree_builder

# torch name in a block -> (flax path, transpose)
BLOCK_MAP = {
    "norm1.weight": ("norm1/scale", False),
    "norm1.bias": ("norm1/bias", False),
    "norm2.weight": ("norm2/scale", False),
    "norm2.bias": ("norm2/bias", False),
    "attn.qkv.weight": ("attn/qkv/kernel", True),
    "attn.qkv.bias": ("attn/qkv/bias", False),
    "attn.proj.weight": ("attn/proj/kernel", True),
    "attn.proj.bias": ("attn/proj/bias", False),
    "attn.rel_pos_h": ("attn/rel_pos_h", False),
    "attn.rel_pos_w": ("attn/rel_pos_w", False),
    "mlp.lin1.weight": ("mlp/fc1/kernel", True),
    "mlp.lin1.bias": ("mlp/fc1/bias", False),
    "mlp.lin2.weight": ("mlp/fc2/kernel", True),
    "mlp.lin2.bias": ("mlp/fc2/bias", False),
}


def _resize_pos_2d(pos: np.ndarray, target_side: int) -> np.ndarray:
    """[1, s, s, C] -> [1, t, t, C] bicubic."""
    if pos.shape[1] == target_side:
        return pos
    return _bicubic(pos, (target_side, target_side))


def convert_sam_state_dict(sd: Dict[str, np.ndarray], target_img: int = 512,
                           patch_size: int = 16) -> dict:
    sd = {k[len("image_encoder."):]: v for k, v in sd.items()
          if k.startswith("image_encoder.")} or sd
    out, put = tree_builder()
    put("pos_embed", _resize_pos_2d(sd["pos_embed"], target_img // patch_size))
    put("patch_embed/kernel",
        sd["patch_embed.proj.weight"].transpose(2, 3, 1, 0))
    put("patch_embed/bias", sd["patch_embed.proj.bias"])

    blk = re.compile(r"^blocks\.(\d+)\.(.+)$")
    for key, val in sd.items():
        m = blk.match(key)
        if not m or m.group(2) not in BLOCK_MAP:
            continue
        fpath, transpose = BLOCK_MAP[m.group(2)]
        put(f"blocks_{int(m.group(1))}/{fpath}", val.T if transpose else val)
    return out


def main(argv=None) -> None:
    cli("Convert a SAM checkpoint", convert_sam_state_dict, ("state_dict",),
        target_patch=False, argv=argv)


if __name__ == "__main__":
    main()
