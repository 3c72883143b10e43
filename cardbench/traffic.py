"""The one generator of inputs: a pool of frames, or of training batches,
made on the device from a seed, by the parameters of a traffic mix file.

A frame is a street-scene-sized image of blocky colour fields plus noise:
``block`` x ``block`` tiles of uniform colours in [0, 256), Gaussian noise
of standard deviation ``noise`` on every pixel, clipped to [0, 255] and
normalised with the configuration's mean and standard deviation (the
program takes preprocessed NHWC float32 images). Every seed gives a pool of
the same size and shape, so seeds change the pixels and not the work's
sizes.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence

import torch


def frame_pool(mix: Dict, preprocessor: Dict, seed: int,
               device) -> torch.Tensor:
    """[pool, H, W, 3] float32 frames on ``device``."""
    n = int(mix["pool"])
    h, w = (int(x) for x in mix["frame_hw"])
    block = int(mix.get("block", 32))
    noise = float(mix.get("noise", 12.0))
    gen = torch.Generator(device=device).manual_seed(seed)
    mean = torch.tensor(preprocessor["mean"], dtype=torch.float32,
                        device=device)
    std = torch.tensor(preprocessor["std"], dtype=torch.float32,
                       device=device)
    out = torch.empty((n, h, w, 3), dtype=torch.float32, device=device)
    for i in range(n):
        coarse = torch.randint(0, 256, (h // block, w // block, 3),
                               generator=gen, device=device).float()
        img = coarse.repeat_interleave(block, 0).repeat_interleave(block, 1)
        img = img + noise * torch.randn((h, w, 3), generator=gen,
                                        device=device)
        out[i] = (img.clamp(0, 255) - mean) / std
    return out


def train_batches(mix: Dict, preprocessor: Dict, seed: int,
                  device) -> list:
    """``batches`` distinct training batches on ``device``: ``batch_size``
    crops of ``crop_hw`` (the frames' colour fields and noise) with labels
    of ``classes`` classes in ``label_block`` x ``label_block`` tiles, a
    share ``ignore_share`` of the tiles ignored (255)."""
    n, b = int(mix["batches"]), int(mix["batch_size"])
    h, w = (int(x) for x in mix["crop_hw"])
    lb = int(mix["label_block"])
    one = dict(mix, pool=n * b, frame_hw=[h, w])
    imgs = frame_pool(one, preprocessor, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    tiles = torch.randint(0, int(mix["classes"]), (n * b, h // lb, w // lb),
                          generator=gen, device=device)
    ignore = torch.rand((n * b, h // lb, w // lb), generator=gen,
                        device=device) < float(mix["ignore_share"])
    tiles = torch.where(ignore, torch.full_like(tiles, 255), tiles)
    labels = tiles.repeat_interleave(lb, 1).repeat_interleave(lb, 2)
    return [dict(img=imgs[i * b:(i + 1) * b].contiguous(),
                 label=labels[i * b:(i + 1) * b].to(torch.int32).contiguous())
            for i in range(n)]


def _narrowing_swap(p: List[int], q: List[int], sizes: Sequence[int],
                    gap: int):
    """One frame, else two, of group ``p`` against as many of ``q`` whose
    exchange narrows the groups' ``gap`` (None where none does)."""
    for n in (1, 2):
        for out in itertools.combinations(p, n):
            for back in itertools.combinations(q, n):
                d = sum(sizes[i] for i in out) - sum(sizes[i] for i in back)
                if 0 < d < gap:
                    return list(out), list(back)
    return None


def balanced_order(sizes: Sequence[int], group: int) -> List[int]:
    """An order of the pool whose consecutive groups of ``group`` frames
    hold totals of ``sizes`` (each frame's windows the gate sends on) as
    even as the frames allow: the largest first into the group with the
    least, then exchanges of one or two frames between two groups while one
narrows their gap. A
    batched path pads each group's refine batch to a bucket, so with the
    pool's total fixed every seed then gives the same batch sizes, in
    another order of frames."""
    count = len(sizes) // group
    groups: List[List[int]] = [[] for _ in range(count)]
    sums = [0] * count
    for i in sorted(range(len(sizes)), key=lambda i: (-sizes[i], i)):
        k = min((k for k in range(count) if len(groups[k]) < group),
                key=lambda k: (sums[k], k))
        groups[k].append(i)
        sums[k] += sizes[i]
    swapped = True
    while swapped:
        swapped = False
        for p in range(count):
            for q in range(count):
                move = _narrowing_swap(groups[p], groups[q], sizes,
                                       sums[p] - sums[q])
                if move:
                    out, back = move
                    groups[p] = [i for i in groups[p] if i not in out] + back
                    groups[q] = [i for i in groups[q] if i not in back] + out
                    d = sum(sizes[i] for i in out) - sum(sizes[i]
                                                         for i in back)
                    sums[p] -= d
                    sums[q] += d
                    swapped = True
    return [i for g in groups for i in sorted(g)]
