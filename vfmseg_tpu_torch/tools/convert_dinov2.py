"""Convert DINOv2 ViT-L/14 torch checkpoints into the backbone param tree.

Port of tools/convert_dinov2.py (the JAX package's) with the same key
mapping: bicubic-resize the patch-embed kernel 14 -> 16 and the position
grid to (512 / 16)^2 = 32 x 32 keeping the cls token (through the port's
``ops/resize.py``, PyTorch's bicubic), transpose linear weights and turn
conv kernels OIHW -> HWIO. The output is the ``backbone`` subtree in the
JAX package's ``.npz`` layout (``/``-joined flax paths), so either
package's ``--backbone-init`` / ``--backbone`` reads it::

    python -m vfmseg_tpu_torch.tools.convert_dinov2 \\
        dinov2_vitl14_pretrain.pth dinov2_converted.npz \\
        [--target-patch 16] [--target-img 512]
"""

from __future__ import annotations

import argparse
import re
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from vfmseg_tpu_torch.ops.resize import resize
from vfmseg_tpu_torch.train.checkpoint import save_pytree


def _bicubic(x: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """Bicubic resize of [..., H, W, C] in fp32 (F.interpolate, no
    antialias, half-pixel centres)."""
    return resize(torch.from_numpy(np.asarray(x, np.float32)), tuple(size),
                  method="bicubic").numpy()


def _resize_patch_kernel(w: np.ndarray, target: int) -> np.ndarray:
    """torch [C_out, 3, p, p] -> bicubic to [C_out, 3, t, t]."""
    if w.shape[-1] == target:
        return w
    x = np.asarray(w, np.float32).transpose(0, 2, 3, 1)  # [O, p, p, I]
    return _bicubic(x, (target, target)).transpose(0, 3, 1, 2)


def _resize_pos_embed(pos: np.ndarray, target_side: int,
                      num_prefix: int = 1) -> np.ndarray:
    """[1, 1+N, C] -> [1, 1+target^2, C], bicubic on the grid part."""
    n = pos.shape[1] - num_prefix
    side = int(round(n ** 0.5))
    if side == target_side:
        return pos
    prefix, grid = pos[:, :num_prefix], pos[:, num_prefix:]
    grid = _bicubic(grid.reshape(1, side, side, pos.shape[-1]),
                    (target_side, target_side))
    return np.concatenate(
        [prefix, grid.reshape(1, target_side * target_side, -1)], axis=1)


def tree_builder() -> tuple:
    """(tree, put): an empty nested tree and ``put("a/b/c", value)``."""
    out: dict = {}

    def put(path: str, value) -> None:
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(value)

    return out, put


def convert_dinov2_state_dict(sd: Dict[str, np.ndarray],
                              target_patch: int = 16,
                              target_img: int = 512) -> dict:
    """torch DINOv2 state_dict (numpy values) -> the ``backbone`` tree."""
    out, put = tree_builder()
    put("cls_token", sd["cls_token"])
    put("pos_embed",
        _resize_pos_embed(sd["pos_embed"], target_img // target_patch))
    pk = _resize_patch_kernel(sd["patch_embed.proj.weight"], target_patch)
    put("patch_embed/kernel", pk.transpose(2, 3, 1, 0))  # OIHW -> HWIO
    put("patch_embed/bias", sd["patch_embed.proj.bias"])

    blk = re.compile(r"^blocks\.(\d+)\.(.+)$")
    linear_map = {
        "attn.qkv": "attn/qkv", "attn.proj": "attn/proj",
        "mlp.fc1": "mlp/fc1", "mlp.fc2": "mlp/fc2",
        "mlp.w12": "mlp/w12", "mlp.w3": "mlp/w3",
    }
    for key, val in sd.items():
        m = blk.match(key)
        if not m:
            continue
        base, rest = f"blocks_{int(m.group(1))}", m.group(2)
        if rest in ("norm1.weight", "norm2.weight"):
            put(f"{base}/{rest.split('.')[0]}/scale", val)
        elif rest in ("norm1.bias", "norm2.bias"):
            put(f"{base}/{rest.split('.')[0]}/bias", val)
        elif rest in ("ls1.gamma", "ls2.gamma"):
            put(f"{base}/{rest.split('.')[0]}/gamma", val)
        else:
            for tname, fname in linear_map.items():
                if rest == f"{tname}.weight":
                    put(f"{base}/{fname}/kernel", val.T)
                elif rest == f"{tname}.bias":
                    put(f"{base}/{fname}/bias", val)
    # the final norm is unused (DINOv2's features are pre-norm) and the
    # mask token is dropped
    return out


def load_state_dict(path: str,
                    wrappers: Sequence[str] = ("state_dict",)) -> dict:
    """A torch checkpoint's state dict as numpy arrays, unwrapped from the
    first of ``wrappers`` it nests under (tensors only: weights_only)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in wrappers:
        if isinstance(sd, dict) and key in sd:
            sd = sd[key]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in sd.items()}


def cli(description: str, convert: Callable, wrappers: Sequence[str],
        target_patch: bool = True, argv=None,
        load: Optional[Callable[[str], dict]] = None) -> None:
    """The converters' shared command line: src, dst, --target-img (and
    --target-patch), or with ``target_patch=None`` neither. ``load`` reads
    the source (default :func:`load_state_dict` with ``wrappers``)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("src", help="torch checkpoint")
    ap.add_argument("dst", help="output .npz param tree")
    if target_patch:
        ap.add_argument("--target-patch", type=int, default=16)
    if target_patch is not None:
        ap.add_argument("--target-img", type=int, default=512)
    args = ap.parse_args(argv)
    sd = (load or (lambda p: load_state_dict(p, wrappers)))(args.src)
    if target_patch:
        tree = convert(sd, args.target_patch, args.target_img)
    elif target_patch is not None:
        tree = convert(sd, args.target_img)
    else:
        tree = convert(sd)
    save_pytree(args.dst, tree)
    with np.load(args.dst) as data:
        n = sum(data[k].size for k in data.files)
    print(f"wrote {args.dst}: {n:,} params")


def main(argv=None) -> None:
    cli("Convert a DINOv2 checkpoint", convert_dinov2_state_dict,
        ("state_dict",), argv=argv)


if __name__ == "__main__":
    main()
