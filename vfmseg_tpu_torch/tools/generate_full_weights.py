"""Merge an adapter/head-only checkpoint with converted backbone weights
into a full segmentor parameter tree, with no jax.

Port of tools/generate_full_weights.py (the JAX package's; the reference
tools/generate_full_weights.py:36-44, the offline alternative to
LoadBackboneHook)::

    python -m vfmseg_tpu_torch.tools.generate_full_weights \\
        --checkpoint work_dirs/run/checkpoints/iter_0040000.trainable.npz \\
        --backbone checkpoints/dinov2_converted.npz --out full_weights.npz

The trainable tree (under ``t/`` in either package's checkpoints) and the
converted backbone (either package's ``convert_*`` output), nested under
the backbone's prefix (``backbone``, or ``model/backbone`` when the
checkpoint was saved from the DomainGeneral wrapper), are merged, the
checkpoint's entries winning, and written in the JAX package's ``.npz``
layout, which both CLIs read.
"""

from __future__ import annotations

import argparse
from typing import Mapping, Tuple

import numpy as np

from vfmseg_tpu_torch.train.checkpoint import load_pytree, save_pytree


def backbone_prefix(tree: Mapping, key: str = "backbone") -> Tuple[str, ...]:
    """The path to the backbone in a parameter tree: ``(key,)`` on a bare
    segmentor, ``(wrapper, key)`` one level down, ``("model", key)`` under
    a DomainGeneral tree whose trainable part holds no backbone entry
    (vfmseg_tpu/train/optim.py:74-86)."""
    if key in tree:
        return (key,)
    for name, sub in tree.items():
        if isinstance(sub, Mapping) and key in sub:
            return (name, key)
    if "model" in tree:
        return ("model", key)
    return (key,)


def _flat(tree: Mapping, prefix: Tuple[str, ...] = ()) -> dict:
    out = {}
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            out.update(_flat(sub, prefix + (name,)))
        else:
            out[prefix + (name,)] = sub
    return out


def _unflat(flat: Mapping) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = leaf
    return tree


def merge(trainable: Mapping, backbone: Mapping) -> dict:
    """``backbone`` nested under :func:`backbone_prefix` of ``trainable``,
    then ``trainable``'s entries over it."""
    prefix = backbone_prefix(trainable) if trainable else ("backbone",)
    flat = {prefix + path: leaf for path, leaf in _flat(backbone).items()}
    flat.update(_flat(trainable))
    return _unflat(flat)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True,
                    help="trainable-partition checkpoint (.npz, 't' tree)")
    ap.add_argument("--backbone", required=True,
                    help="converted backbone weights (.npz)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    trainable = load_pytree(args.checkpoint)
    trainable = trainable.get("t", trainable)
    save_pytree(args.out, merge(trainable, load_pytree(args.backbone)))
    with np.load(args.out) as data:
        n = sum(data[k].size for k in data.files)
    print(f"wrote {args.out}: {n:,} params")
    return args.out


if __name__ == "__main__":
    main()
