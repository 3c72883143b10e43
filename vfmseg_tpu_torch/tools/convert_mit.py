"""Convert SegFormer MiT (mit_b0..b5) checkpoints into the backbone param
tree.

Port of tools/convert_mit.py (the JAX package's) with the same key mapping,
without jax: the official-SegFormer / mmseg layout
(``patch_embed{i}.proj/norm``, ``block{i}.{j}.{norm1, attn.{q, kv, proj,
sr, norm}, norm2, mlp.{fc1, dwconv.dwconv, fc2}}``, ``norm{i}``) onto
``models/backbones/mit.py`` (``patch_embed{i}``, ``embed_norm{i}``,
``stage{i}_block{j}``, ``norm{i}``); linear weights transposed, conv kernels
OIHW -> HWIO (the depthwise ``[C, 1, 3, 3]`` to ``[3, 3, 1, C]``), the
classifier ``head.*`` dropped, every array fp32. The output is the
``backbone`` subtree in the JAX package's ``.npz`` layout::

    python -m vfmseg_tpu_torch.tools.convert_mit mit_b5.pth \\
        mit_b5_converted.npz
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

from vfmseg_tpu_torch.tools.convert_dinov2 import (
    cli,
    load_state_dict,
    tree_builder,
)


def _conv(w: np.ndarray) -> np.ndarray:
    return np.asarray(w).transpose(2, 3, 1, 0)  # OIHW -> HWIO


def convert_mit_state_dict(state: Dict[str, np.ndarray]) -> dict:
    """A MiT state dict (numpy values) -> the ``backbone`` tree."""
    out, put_raw = tree_builder()

    def put(path: str, value) -> None:
        put_raw(path, np.asarray(value, np.float32))

    def ln(dst: str, src: str) -> None:
        put(f"{dst}/scale", state[f"{src}.weight"])
        put(f"{dst}/bias", state[f"{src}.bias"])

    def dense(dst: str, src: str) -> None:
        put(f"{dst}/kernel", np.asarray(state[f"{src}.weight"]).T)
        put(f"{dst}/bias", state[f"{src}.bias"])

    for i in range(1, 5):
        put(f"patch_embed{i}/kernel",
            _conv(state[f"patch_embed{i}.proj.weight"]))
        put(f"patch_embed{i}/bias", state[f"patch_embed{i}.proj.bias"])
        ln(f"embed_norm{i}", f"patch_embed{i}.norm")
        ln(f"norm{i}", f"norm{i}")
        depth = 1 + max(int(m.group(1)) for k in state
                        if (m := re.match(rf"block{i}\.(\d+)\.", k)))
        for j in range(depth):
            src, dst = f"block{i}.{j}", f"stage{i}_block{j}"
            ln(f"{dst}/norm1", f"{src}.norm1")
            ln(f"{dst}/norm2", f"{src}.norm2")
            for name in ("q", "kv", "proj"):
                dense(f"{dst}/attn/{name}", f"{src}.attn.{name}")
            if f"{src}.attn.sr.weight" in state:
                put(f"{dst}/attn/sr/kernel",
                    _conv(state[f"{src}.attn.sr.weight"]))
                put(f"{dst}/attn/sr/bias", state[f"{src}.attn.sr.bias"])
                ln(f"{dst}/attn/sr_norm", f"{src}.attn.norm")
            dense(f"{dst}/mlp/fc1", f"{src}.mlp.fc1")
            put(f"{dst}/mlp/dwconv/kernel",
                _conv(state[f"{src}.mlp.dwconv.dwconv.weight"]))
            put(f"{dst}/mlp/dwconv/bias",
                state[f"{src}.mlp.dwconv.dwconv.bias"])
            dense(f"{dst}/mlp/fc2", f"{src}.mlp.fc2")
    return out


def _load(path: str) -> Dict[str, np.ndarray]:
    return {k: v for k, v in load_state_dict(path).items()
            if not k.startswith("head.")}


def main(argv=None) -> None:
    cli("Convert a MiT checkpoint", convert_mit_state_dict, ("state_dict",),
        target_patch=None, argv=argv, load=_load)


if __name__ == "__main__":
    main()
