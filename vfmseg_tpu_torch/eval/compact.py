"""Compact (gated) two-stage inference: only low-confidence windows are refined.

Port of vfmseg_tpu/eval/compact.py:41-510 without its ``mesh`` sharding. The
dense path (``slide.ms_slide_inference``) refines every window and selects
afterwards; with a trained model most windows pass the confidence gate
(0.968 / 0.8, the reference's), so this engine skips their refine forwards.

* Stage 1: the whole image at ``lr_size``, upsampled to full size, and each
  window's confident-pixel fraction as a box sum of the 0/1 confident mask
  (``window_confidence``).
* The host reads the small confidence vector back and picks the refine batch
  size k: the number of windows below ``conf``, rounded up to a bucket of
  ``DEFAULT_BUCKETS``, which bounds the refine shapes.
* The finish step chooses the windows again on the device from the same
  confidences (ascending ids, padded with a sentinel up to k), gathers their
  image and stage-1 windows, refines them, and adds the deltas back over the
  stage-1 map: ``out = full + coverage^-1 * sum(refined_w - full|box_w)``
  over the refined windows, which equals the dense overlap average. The add
  is B9 (``ops/window_blend.py``): on CUDA one kernel launch per finish step.

The blend runs in fp32 and the logits come out in fp32, as the dense path's
overlap average does. Here the port departs from the JAX engine, which
blends in the model's dtype: under a bf16 model with a trained-like gate
(the decode head's logits scaled until 0.8 of the windows skip) each bf16
delta and each bf16 add rounds at the stage-1 logits' large magnitude, and
on an H100 0.10-0.57% of the pixels' argmax left the dense path's; in fp32
0-0.03% (ROADMAP §C). With fp32 models (the CPU tests) both engines compute
the same chain.

``stream`` runs groups of images through one stage-1 call each and keeps
``depth`` groups in flight: group j+1's stage 1 is queued before the host
waits for group j's confidences, which it copies into pinned host memory
behind a CUDA event as soon as stage 1 is queued.

Profiler ranges (``utils/profiling.py`` ``span``): ``vfmseg.stage1``
(stage 1 and the window shares; in the stream from the group's stack
through the readback's start) and ``vfmseg.refine`` (a finish step that
refines, its gathers and the blend). The stream's ranges carry the group's
ordinal, ``vfmseg.stage1#12``, so one group's two phases share it; none is
open across a ``yield``.

As in the rest of ``eval/``, the lr/hr functions take the weights at call
time (``variables``: the segmentor, or anything the functions accept).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, Iterable, Iterator, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vfmseg_tpu_torch.eval.slide import (
    _coverage_inv,
    compute_slide_grid,
    confident_mask,
)
from vfmseg_tpu_torch.ops.resize import resize
from vfmseg_tpu_torch.ops.window_blend import blend_windows
from vfmseg_tpu_torch.utils.profiling import span

# refine batch sizes: spacing 2 through the operating band (a group of 8 at
# ~0.8 skip needs ~29 windows), the JAX package's table
DEFAULT_BUCKETS = (0, 1, 2, 4, 8, 12, 16, 20, 22, 24, 26, 28, 30, 32, 34,
                   36, 38, 40, 44, 48, 50, 52, 54, 56, 58, 60, 62, 64, 66,
                   68, 72, 80, 96, 128, 160)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    # beyond the table: a multiple of 32, so every needed window is refined
    return -(-n // 32) * 32


def window_confidence(full: torch.Tensor, boxes, crop: Tuple[int, int],
                      threshold: float) -> torch.Tensor:
    """Per-window confident-pixel fraction of the full-size logits [B, H, W,
    C], box-major [G*B] (window w is box w // B of image w % B).

    Box sums of the 0/1 mask through its integral image: every prefix sum is
    an integer below 2^24, exact in fp32 in any summation order, so the
    fractions equal the dense gate's window means bit for bit. ``boxes``: the
    (y, x) origins, as a list or an int tensor [G, 2] on ``full``'s device."""
    ch, cw = crop
    mask = confident_mask(full, threshold)
    s = F.pad(mask.cumsum(1).cumsum(2), (1, 0, 1, 0))      # [B, H+1, W+1]
    yx = torch.as_tensor(boxes, dtype=torch.long, device=full.device)
    ys, xs = yx[:, 0], yx[:, 1]
    sums = (s[:, ys + ch, xs + cw] - s[:, ys + ch, xs]
            - s[:, ys, xs + cw] + s[:, ys, xs])            # [B, G]
    return (sums / float(ch * cw)).t().reshape(-1)


def _gather_windows(x: torch.Tensor, img_i: torch.Tensor, ys: torch.Tensor,
                    xs: torch.Tensor, crop: Tuple[int, int]) -> torch.Tensor:
    """[B, H, W, C] and per-window (image, y, x) -> [K, ch, cw, C]."""
    ch, cw = crop
    rows = ys[:, None, None] + torch.arange(ch, device=x.device)[None, :, None]
    cols = xs[:, None, None] + torch.arange(cw, device=x.device)[None, None, :]
    return x[img_i[:, None, None], rows, cols]


class CompactMsSlide:
    """Reusable gated two-stage predictor for one (model, test_cfg).

    ``forced_bucket`` (measurement mode): every stream group refines exactly
    that many windows, still chosen on the device, and the per-group
    readback disappears; a group that needs more refines only the first
    ``forced_bucket`` (ascending ids), so this mode is not the dense path's
    result."""

    def __init__(self, lr_logits_fn: Callable, hr_logits_fn: Callable, *,
                 crop: Tuple[int, int] = (512, 512),
                 stride: Tuple[int, int] = (320, 320),
                 lr_size: Tuple[int, int] = (512, 1024),
                 threshold: float = 0.968, conf: float = 0.8,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 align_corners: bool = False, forced_bucket: int = None):
        self.lr_fn = lr_logits_fn
        self.hr_fn = hr_logits_fn
        self.crop = tuple(crop)
        self.stride = tuple(stride)
        self.lr_size = tuple(lr_size)
        self.threshold = threshold
        self.conf = conf
        self.buckets = buckets
        self.align_corners = align_corners
        self.forced_bucket = forced_bucket
        self._tables: Dict[tuple, tuple] = {}
        self.reset_stats()

    def reset_stats(self):
        """Zero the gate counters: windows seen, windows refined, and rows
        through the refine head (refined windows plus bucket padding).
        ``1 - stat_refined / stat_windows`` is the measured skip rate."""
        self.stat_windows = 0
        self.stat_refined = 0
        self.stat_refine_rows = 0

    def _geometry(self, img_hw: Tuple[int, int], device: torch.device):
        """Device constants of one image size, made once: box origins [G, 2],
        their ys and xs, and the inverse coverage plane [H, W, 1]."""
        key = (tuple(img_hw), device)
        if key not in self._tables:
            boxes = compute_slide_grid(tuple(img_hw), self.crop, self.stride)
            yx = torch.tensor(boxes, dtype=torch.long, device=device)
            inv = torch.from_numpy(_coverage_inv(
                tuple(boxes), self.crop, tuple(img_hw)).copy()).to(device)
            self._tables[key] = (yx, yx[:, 0].contiguous(),
                                 yx[:, 1].contiguous(), inv)
        return self._tables[key]

    def _stage1_impl(self, variables, img: torch.Tensor, img_hw):
        full = self.lr_fn(variables, resize(
            img, size=self.lr_size, method="bilinear",
            align_corners=self.align_corners))
        # contiguous [B, H, W, C]: the blend updates it (or its fp32 copy)
        # in place
        full = resize(full, size=img_hw, method="bilinear",
                      align_corners=self.align_corners).contiguous()
        yx = self._geometry(img_hw, img.device)[0]
        return full, window_confidence(full, yx, self.crop, self.threshold)

    def _finish_step(self, variables, img: torch.Tensor, full: torch.Tensor,
                     confidence: torch.Tensor, real: int, k: int,
                     tag: str = "") -> torch.Tensor:
        """Refine k windows chosen on the device and blend them into an
        fp32 base: ``full`` itself when it is fp32, else an fp32 copy.
        Returns the base. With k > 0 this is the range
        ``vfmseg.refine<tag>``."""
        if k == 0:
            return full.float()
        with span("vfmseg.refine" + tag):
            base = full.float()
            b = img.shape[0]
            n = confidence.numel()
            _yx, ys_tab, xs_tab, inv_full = self._geometry(img.shape[1:3],
                                                           img.device)
            # the k smallest masked window ids, ascending, padded with a
            # sentinel (np.nonzero's order); batch-pad images never refine
            w_ids = torch.arange(n, device=img.device)
            mask = (confidence < self.conf) & ((w_ids % b) < real)
            vals = torch.where(mask, w_ids, n)
            if k > n:
                vals = torch.cat([vals, vals.new_full((k - n,), n)])
            idx = torch.sort(vals).values[:k]
            valid = idx < n
            idx = idx.clamp(max=n - 1)
            img_i = idx % b
            box_j = idx // b
            ys, xs = ys_tab[box_j], xs_tab[box_j]
            g_img = _gather_windows(img, img_i, ys, xs, self.crop)
            g_ctx = _gather_windows(full, img_i, ys, xs, self.crop)
            refined = self.hr_fn(variables, g_img, g_ctx).to(full.dtype)
            # pad rows add a zero delta, so their duplicated origins change
            # nothing
            delta = torch.where(valid[:, None, None, None],
                                refined.float() - g_ctx.float(), 0.0)
            zeros = torch.zeros_like(img_i)
            inv_w = _gather_windows(inv_full[None], zeros, ys, xs, self.crop)
            return blend_windows(base, (delta * inv_w).contiguous(),
                                 img_i.int(), ys.int(), xs.int())

    @torch.inference_mode()
    def __call__(self, variables, img: torch.Tensor):
        """img [B, H, W, 3] -> (logits [B, H, W, C], windows refined)."""
        with span("vfmseg.stage1"):
            full, confidence = self._stage1_impl(variables, img,
                                                 tuple(img.shape[1:3]))
        return self._finish(variables, img, full, confidence,
                            confidence.cpu().numpy())

    def _finish(self, variables, img, full, confidence, conf_host: np.ndarray,
                real: int = None, tag: str = ""):
        """``conf_host`` (the host copy of ``confidence``) picks only the
        bucket size k and feeds the counters; the finish step chooses the
        windows again on the device. ``tag`` ends the refine range's
        name."""
        g = img.shape[0]
        if real is None:
            real = g
        if real < g:
            # batch-pad images (window i belongs to image i % g) never count
            conf_host = conf_host.copy()
            conf_host[np.arange(conf_host.size) % g >= real] = np.inf
            self.stat_windows += (conf_host.size // g) * real
        else:
            self.stat_windows += conf_host.size
        need = int(np.count_nonzero(conf_host < self.conf))
        self.stat_refined += need
        k = _bucket(need, self.buckets) if need else 0
        self.stat_refine_rows += k
        return self._finish_step(variables, img, full, confidence, real,
                                 k, tag), need

    @staticmethod
    def _start_readback(confidence: torch.Tensor):
        """Start the confidences' copy to the host: on CUDA into pinned
        memory, non-blocking, behind an event."""
        if confidence.device.type != "cuda":
            return confidence, None
        host = torch.empty(confidence.shape, dtype=confidence.dtype,
                           pin_memory=True)
        host.copy_(confidence, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    @staticmethod
    def _wait_readback(readback) -> np.ndarray:
        host, event = readback
        if event is not None:
            event.synchronize()
        return host.numpy()

    @torch.inference_mode()
    def stream(self, variables, images: Iterable[torch.Tensor],
               group: int = 4, depth: int = 2) -> Iterator[torch.Tensor]:
        """Throughput path: iterate ``images`` ([H, W, 3] tensors on the
        model's device), yielding per-image logits [H, W, C] in order.

        Stage 1 runs ``group`` images in one call, and the refine batch draws
        windows from the whole group; a group ends early when the image size
        changes. ``depth`` groups stay in flight, so the host's wait for a
        group's confidences overlaps the next groups' device work."""

        def chunks():
            buf = []
            for im in images:
                if buf and im.shape != buf[0].shape:
                    yield buf
                    buf = []
                buf.append(im)
                if len(buf) == group:
                    yield buf
                    buf = []
            if buf:
                yield buf

        if self.forced_bucket is not None:
            # no per-group readback: a fixed refine batch per group, the
            # counters read at the end
            confs = []
            for buf in chunks():
                img = torch.stack(buf)
                full, confidence = self._stage1_impl(
                    variables, img, tuple(img.shape[1:3]))
                confs.append(confidence)
                logits = self._finish_step(variables, img, full, confidence,
                                           len(buf), self.forced_bucket)
                self.stat_refine_rows += self.forced_bucket
                yield from logits
            for confidence in confs:
                need = int((confidence < self.conf).sum())
                self.stat_windows += confidence.numel()
                self.stat_refined += min(need, self.forced_bucket)
            return

        def finish(g, img, full, confidence, readback):
            logits, _n = self._finish(variables, img, full, confidence,
                                      self._wait_readback(readback),
                                      tag=f"#{g}")
            yield from logits

        pending = deque()
        for g, buf in enumerate(chunks()):
            with span(f"vfmseg.stage1#{g}"):
                img = torch.stack(buf)
                full, confidence = self._stage1_impl(variables, img,
                                                     tuple(img.shape[1:3]))
                readback = self._start_readback(confidence)
            pending.append((g, img, full, confidence, readback))
            if len(pending) > depth:
                yield from finish(*pending.popleft())
        while pending:
            yield from finish(*pending.popleft())
