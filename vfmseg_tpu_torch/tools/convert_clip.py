"""Convert a CLIP ViT-L visual tower into the backbone param tree.

Port of tools/convert_clip.py (the JAX package's) with the same key mapping,
without jax: keep the ``visual.*`` entries of an OpenAI CLIP checkpoint (a
``torch.jit`` archive or a state dict), resize the position grid to
(512 / 16)^2 = 32 x 32 bilinearly by size keeping the cls slot, the patch
kernel 14 -> 16 bicubically (both through the port's ``ops/resize.py``,
PyTorch's interpolation), and map the fused ``in_proj`` to ``qkv``,
``out_proj`` to ``proj`` and ``mlp.c_fc``/``mlp.c_proj`` to ``fc1``/``fc2``;
``ln_post`` and ``proj`` (the embedding head) are dropped. The output is the
``backbone`` subtree in the JAX package's ``.npz`` layout::

    python -m vfmseg_tpu_torch.tools.convert_clip ViT-L-14.pt \\
        clip_converted.npz [--target-patch 16] [--target-img 512]
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from vfmseg_tpu_torch.ops.resize import resize
from vfmseg_tpu_torch.tools.convert_dinov2 import (
    _resize_patch_kernel,
    cli,
    load_state_dict,
    tree_builder,
)

_BLOCK = re.compile(r"^transformer\.resblocks\.(\d+)\.(.+)$")
# reference key -> (flax path under blocks_<i>, transpose)
_BLOCK_MAP = {
    "ln_1.weight": ("norm1/scale", False),
    "ln_1.bias": ("norm1/bias", False),
    "ln_2.weight": ("norm2/scale", False),
    "ln_2.bias": ("norm2/bias", False),
    "attn.in_proj_weight": ("attn/qkv/kernel", True),
    "attn.in_proj_bias": ("attn/qkv/bias", False),
    "attn.out_proj.weight": ("attn/proj/kernel", True),
    "attn.out_proj.bias": ("attn/proj/bias", False),
    "mlp.c_fc.weight": ("mlp/fc1/kernel", True),
    "mlp.c_fc.bias": ("mlp/fc1/bias", False),
    "mlp.c_proj.weight": ("mlp/fc2/kernel", True),
    "mlp.c_proj.bias": ("mlp/fc2/bias", False),
}


def _resize_pos_bilinear(pos: np.ndarray, target_side: int) -> np.ndarray:
    """CLIP pos embed [1 + n, C] -> [1 + t^2, C], bilinear grid resize."""
    side = int(round((pos.shape[0] - 1) ** 0.5))
    if side == target_side:
        return pos
    grid = torch.from_numpy(np.asarray(pos[1:], np.float32)).reshape(
        1, side, side, -1)
    grid = resize(grid, size=(target_side, target_side), method="bilinear")
    return np.concatenate(
        [pos[:1], grid.numpy().reshape(target_side * target_side, -1)])


def convert_clip_state_dict(sd: Dict[str, np.ndarray],
                            target_patch: int = 16,
                            target_img: int = 512) -> dict:
    """A CLIP state dict (numpy values; ``visual.*`` or bare) -> the
    ``backbone`` tree."""
    sd = {k[len("visual."):]: v for k, v in sd.items()
          if k.startswith("visual.")} or sd
    out, put = tree_builder()
    put("class_embedding", sd["class_embedding"])
    pos = _resize_pos_bilinear(sd["positional_embedding"],
                               target_img // target_patch)
    put("pos_embed", pos[None])
    pk = _resize_patch_kernel(sd["conv1.weight"], target_patch)
    put("patch_embed/kernel", pk.transpose(2, 3, 1, 0))  # OIHW -> HWIO
    put("ln_pre/scale", sd["ln_pre.weight"])
    put("ln_pre/bias", sd["ln_pre.bias"])
    for key, val in sd.items():
        m = _BLOCK.match(key)
        if m and m.group(2) in _BLOCK_MAP:
            path, transpose = _BLOCK_MAP[m.group(2)]
            put(f"blocks_{int(m.group(1))}/{path}",
                val.T if transpose else val)
    return out


def load_clip(path: str) -> Dict[str, np.ndarray]:
    """The fp32 state dict of a ``torch.jit`` archive (OpenAI's release
    format) or of a plain checkpoint, as numpy arrays."""
    try:
        sd = torch.jit.load(path, map_location="cpu").float().state_dict()
    except RuntimeError:
        return load_state_dict(path)
    return {k: v.numpy() for k, v in sd.items()}


def main(argv=None) -> None:
    cli("Convert a CLIP visual tower", convert_clip_state_dict,
        ("state_dict",), argv=argv, load=load_clip)


if __name__ == "__main__":
    main()
