#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card and check them:
the gated inference and the two-scale train step of the headline model
(LoRA DINOv2-L) and of the same MsVFM segmentor on LoRA EVA02-L and on LoRA
SAM ViT-H (on B7's route and on the ``pallas_bias`` route), the headline
through the compact gated engine and the eval CLI's dataset loop, the
slide eval of LoRA DINOv2-L with the Mask2Former head, the Rein model
(``dg_rein_dinov2_mask2former``) served and trained, train steps of two
LoRA encoder-decoders, and LoRA CLIP-L (MsVFM), Rein CLIP-L under the Rein
Mask2Former head, HRDA and SegFormer on Rein DINOv2-L and MiT-B5 with the
DAFormer head, each served and trained; and the algorithms: the headline
trained in DomainGeneral with its masked-consistency branch, and the DACS
UDA step with its EMA teacher on Rein DINOv2-L with SegFormer (through the
train CLI), Mask2Former and HRDA; and the scale-out and tooling: the train
and eval CLIs in a one-rank NCCL group, DINOhead at head dim 32 (B5's D-32
instantiations), the headline step with remat, the debug grids.

Usage, from the root of the repository: ``python3 chip_smoke.py``

Phases, each printing one JSON line:

1. device: the card (nvidia-smi name and power limit), torch and CUDA
   versions; TF32 is switched off for matmuls and cuDNN so fp32 comparisons
   are fp32.
2. build: the CUDA kernels of ``vfmseg_tpu_torch/csrc`` built by nvcc, one
   process per source started together (or loaded from the build cache),
   with the build seconds and ptxas' register counts; registers, spills and
   static shared memory by instantiation of B2/B3's warp-specialised
   kernel and of B5's forward and fused backward, and ptxas' lines on any
   wgmma it serialised or fenced (``wgmma_warnings``: C75xx codes,
   injected ``warpgroup.arrive`` / ``warpgroup.wait``).
3. kernels: the DINOv2 inference kernels (LayerNorm, fused-qkv attention)
   against their plain PyTorch versions on the card, at the shapes the
   inference path gives them, from seeded bf16 inputs (the plain version
   runs in fp32), plus one fp32 LayerNorm and four attention cases off the
   path (an odd head count, an idle second slab, a tail after one step, a
   single 16-key step), MiT-B5's stage 4 at a 512x1024 image and the
   DACS teacher's batch of 2 (TEACHER_ATTN_SHAPE); the attention's device
   ms by the profiler beside SDPA's.
4. kernels_train: the training attention kernels (B3 forward with LSE, and
   its backward, B4's function, through ``attention_bwd_tm`` on B5's fused
   backward over [B, H, N, 64] views of the token-major tensors) at the
   DINOv2 train path's shapes plus ragged cases off the path and MiT-B5's
   stage 4 in its bs 2 step, with fused qkv and with three tensors,
   against ``attention_fwd_lse_plain`` and autograd through the fp32 plain
   attention with a random dO; B3's device ms by the profiler beside the
   faster of the two PyTorch calls that also return the LSE
   (``_scaled_dot_product_flash_attention`` and
   ``_scaled_dot_product_cudnn_attention``), each reported.
5. kernels_eva02: the LayerNorm at EVA02's SwiGLU width 2730 (refine
   batch, stage 1, train batch; an odd width and fp32 off the path) and at
   cases off the paths (``LN_OFF_PATH_CASES``: every head length the kernel
   peels, odd widths, one row, fp32, a row too wide for a warp), B2-RoPE at
   the EVA02 path's shapes with its tables and at five cases off the path
   (odd heads, N 17, N 129, batch 1, v at a stride of its own), its
   rotation pass's workspace held bit for bit to the twin's rotation and
   timed alone by the profiler, the SwiGLU gate-and-sub-LN kernel
   (``SWIGLU_CASES``: the padded eval route's refine batch and stage 1, an
   aligned width, fp32, a row past a block's registers) against its plain
   twin, and the head-major attention
   (B5: forward with LSE, the fused backward for dq, dk and dv) at the
   EVA02 train path's shape over token-major strided views and at a ragged
   Nq != Nk case, which ``multi_head_attention`` must route to B5.
6. kernels_sam: the rel-pos attention (B7) at the six shapes of SAM's
   paths (windowed and global blocks of stage 1, the refine batch and the
   train step; head dim 80, q, k, v strided views of one fused qkv tensor,
   rel terms from ``decomposed_rel_pos_terms_hm``) and at six cases off the
   path that reach the kernel's other branches (``RELPOS_OFF_PATH``: odd
   kw, a 16-key tail, head dim 64, a whole masked step, a grid too wide
   for the warp-specialised kernel, contiguous q, k, v with one or more
   heads), against ``attention_decomposed_plain``;
   then B5's
   forward entry with the LSE off, which computes B6's function, timed at
   (18, 16, 1025) against ``attention_plain``, SDPA and its bound.
6b. kernels_compact: the window blend (B9) against ``blend_windows_plain``,
   bit-identical, at the compact path's shapes (``BLEND_CASES``: a
   1024x2048 image's fp32 base with k = 20 and 4, a group of 8 images'
   fp32 base with k = 30 and 160, pad rows included, and the bf16 base the
   JAX engine blends in at k = 20 and 30), with
   ``index_put_(accumulate=True)`` as the library yardstick.
6c. kernel_attention_hm_bias / kernel_deform_sample: B5's two bias
   entries (forward with LSE, the fused backward with dbias in the bias's
   dtype) at SAM's six path shapes (head dim 80, the bf16 bias
   ``decomposed_rel_pos_bias_hm`` builds) and a ragged Nq != Nk case with a
   bias broadcast over the heads, against autograd through the fp32 plain
   version, with SDPA and a float ``attn_mask`` as the yardstick, then the
   same six shapes with an fp32 bias (off the path: SAM builds bf16); B8
   at the pixel decoder's eval shape in bf16 and fp32 and at off-path cases
   (5 channels in fp32 and bf16, 64 channels, 36 channels on a value 8
   bytes off a 16-byte boundary in bf16 and fp32: every access width),
   coordinates partly outside, against ``sample_plain`` in fp32, with
   ``F.grid_sample`` as the yardstick. kernel_deform_attn: the fused
   deformable core (``csrc/deform_attn.cu``) at one encoder layer of
   Rein's slide in bf16 and fp32, a train batch and nine cases off the path
   (``DEFORM_ATTN_CASES``), against ``ms_deform_attn_plain`` in fp32, with
   the B8 chain it replaced on the eval route as the yardstick.
7. main_path / eva02_main_path / sam_main_path: each model at full width
   with seeded weights in bf16, built on the card, through ``predict`` on 3
   synthetic 1024x2048 images; launch counts per kernel, asserted per image
   (no training kernel may launch), latency, images/s and peak memory.
8. card_vs_cpu / eva02_card_vs_cpu / sam_card_vs_cpu: one 512x1024 image
   through the gated slide logits on the card (bf16) and on the CPU (fp32,
   plain path), same seeded weights; then main_breakdown /
   eva02_main_breakdown / sam_main_breakdown: one more image through
   ``predict`` under ``torch.profiler`` for the kernels' device time,
   against the synchronised wall time of unprofiled images.
   The same three phases and those of 9-11 run for SAM on the bias route
   (sam_bias_*: ``compute.attn_impl = "pallas_bias"``), and main_path,
   card_vs_cpu, main_breakdown (with the fused deformable core's share) and
   an eval_cli loop for
   ``dg_lora_dinov2_mask2former`` (m2f_*: the slide predictor at 512 / 341,
   18 crops per image; card vs CPU on a 512x1024 image, 3 crops).
9. train_path / eva02_train_path / sam_train_path: each model at full
   width in training mode (bf16 compute, fp32 master weights, LoRA, both
   heads; EVA02 with drop-path 0.1, LoRA dropout 0.1 in every config),
   batch 2 of synthetic 1024x1024 crops through ``InfiniteLoader`` and
   ``train_loop`` for 8 steps (DINOv2: checkpoints at steps 4 and 8, then a
   fresh state restored from step 8); launch counts asserted per step,
   per-step latency, steady steps/s and peak memory.
10. train_breakdown / eva02_train_breakdown / sam_train_breakdown: one
   more step split by CUDA events into forward, backward and optimizer, and
   a ``torch.profiler`` pass over one step for the kernels' device time and
   the idle share.
11. train_card_vs_cpu / eva02_train_card_vs_cpu / sam_train_card_vs_cpu:
   one train step of the full-width model at 256x256 (HR crop 128) on the
   card in bf16 and on the CPU in fp32, same seeded weights and crop box,
   dropout, drop-path and mask ratio 0: loss entries, the cosine of the
   flattened LoRA gradients, and the LoRA gradient norm and ``grad_norm``.
12. compact_calibration / compact_per_image / compact_stream /
   compact_eval_cli: the headline at full width with ``gate=compact``. The
   decode head's logit scale is bisected until the gate skips ~0.8 of the
   windows of 16 synthetic 1024x2048 images (``calibrate_logit_scale``);
   the compact per-image predictor runs all 16 (launches asserted per
   image: one stage-1 ViT, and for an image with refined windows one refine
   ViT and decoder and one B9), and on 4 of them its logits meet the dense
   path's (the same refined windows, argmax agreement, q99 drift); the
   stream (``stream_evaluate``, group 8) runs all 16 with its launches
   asserted per group, its predictions held to the per-image ones, its
   images/s, group times, measured skip, refined and padded windows and
   peak memory, and one profiled pass; then ``evaluate_dataset``, the eval
   CLI's loop, over a 4-image in-memory labelled set, printing its metrics
   JSON.

13. train_cli: the train CLI (``tools/train.py``'s ``run``) on the
   headline's config file, read by the port's loader at full width in
   bf16: 8 in-memory synthetic samples at GTA's frame (1052x1914, 19
   classes) as the source, with the RCS statistics files written to a
   temporary data root, through the config's own pipeline (resize to
   2560x1440, 1024^2 cat-max-ratio crop, flip, photometric distortion,
   RCS, 4 loader threads); 6 steps (checkpoints at 3 and 6, validation and
   save_best on one 1024x2048 image at 6), then ``--resume`` to step 8. It
   checks every step's logged loss and grad_norm, the checkpoints, the val
   line, that the resumed run starts at step 6 with the trainable
   parameters bit-equal to the step-6 checkpoint, and the launches (per
   step and per validation image as in 9 and 7); it reports the loader's
   own samples/s (16 samples, no model), the CLI's steps/s over steps
   2-6, one profiled step's device time and its idle share against the
   CLI's step, peak memory and the validation's seconds.

14. rein_main_path / rein_card_vs_cpu / rein_main_breakdown:
   ``dg_rein_dinov2_mask2former`` (LoRAReins on DINOv2-L, the x4/x2/x1/x0.5
   pyramid, the ReinMask2FormerHead fed the Rein queries) at full width
   in bf16: 3 synthetic 1024x2048 images through the slide predictor (512
   / 341, 18 crops an image; launches asserted per image: 97 LN, 24 B2,
   6 fused deformable cores, no B8), card vs CPU on a 512x1024 image at Mask2Former's limits, a
   profiled image with the deformable core's share. rein_train_path /
   rein_train_breakdown: 8 steps at bs 2, 512^2 through train_loop
   (checkpoints at 4 and 8, a fresh state restored from 8; launches per
   step asserted, ``PER_STEP["rein"]``; every frozen ViT weight bit-equal
   after; the set loss's host matching ms a step), then a profiled step
   and rein_train_split (events and host ms of the backbone, the head
   and the set loss, forward and backward).
   rein_train_card_vs_cpu: one step at 256^2 on the card in bf16 and the
   CPU in fp32 from the same weights, batch and point draws: the share of
   equal matchings, each card matching's excess cost under the CPU's
   costs, the loss entries, the reins' gradient cosine and grad_norm
   (``SET_*`` limits). B8 is also checked at the pyramid's six level
   shapes (``DEFORM_REIN``).
15. encdec_train: 3 steps each of ``dg_lora_dinov2_mask2former`` and
   ``dg_lora_dinov2_linearhead`` at bs 2, 512^2 through train_loop, with
   their launches per step asserted and finite losses.
16. clip_*: ``dg_lora_clip_ms_masked`` (LoRA on CLIP-L's proj/fc1/fc2,
   drop-path 0.1) through the phases of 7-11: 3 images of dense gated
   inference, card vs CPU (then clip_stem_from_cpu: the card's run again
   with the stem's output, ln_pre's input, taken from the CPU's run, a
   reading with no limit), a profiled image, 8 train steps at bs 2 (block
   0 attends on B2: its input needs no gradient), a profiled step, one step
   card vs CPU at 256^2.
17. rein_clip_m2f_*: ``rein_clip_l_mask2former_512x512_bs1x4`` (LoRAReins
   on CLIP-L, the x4/x2/x1/x0.5 resize then ClipFPN, the Rein Mask2Former
   head): the slide eval of one image and a profiled one, and 3 train
   steps at bs 4, 512^2 in which ClipFPN's BatchNorm statistics must
   move.
18. hrda_*: ``dg_rein_dinov2_hrda_1024x1024``: the slide eval of one image
   (3 windows of 1024, each an LR pass and 9 HR crops, the 3 windows' LR
   views and their 27 crops each one ViT batch), card vs CPU at 512x1024,
   a profiled image, the eval CLI's loop, 3 train steps at bs 2, 1024^2
   (the LR view and the HR crop through two ViT calls a step).
19. segformer_*: ``dg_rein_dinov2_segformer``: the slide eval of one image,
   a profiled one and 3 train steps at bs 2, 512^2.
20. kernel_layer_norm_mit / kernel_attention_hm_mit / mit_*: B1 at MiT-B5's
   LayerNorm shapes (``MIT_LN_CASES``; B2 and B3 at its stage 4 are cases
   of phases 2 and 3); B5's forward and fused backward at MiT-B5's three
   stage shapes (``MIT_HM_SHAPES``, k and v views of one kv tensor) against
   the plain versions, timed by events and by CUDA-graph replay beside
   SDPA, with the bound; then ``daformer_sepaspp_mitb5`` (MiT-B5 + DAFormer
   with sep-ASPP): the whole inference of one 512x1024 image, card vs CPU
   at 512x1024, a profiled one, 3 train steps at bs 2, 512^2 (every
   parameter trains) and a profiled step.

21. dg_consistency / dg_train_breakdown / dg_wrapped_prediction /
   dg_train_card_vs_cpu: ``dg_lora_dinov2_ms_masked_consistency`` (the
   headline in DomainGeneral with the masked-consistency branch) at full
   width: DG_STEPS bs 2, 1024^2 steps through train_loop (launches a step:
   the headline's twice; the mask.* losses finite and nonzero), a profiled
   step, the wrapped dense gated prediction of one 1024x2048 image
   bit-equal to its inner model's, and one 256^2 step card vs CPU with the
   same host draws (the TRAIN_* limits, mask.* entries included).
22. uda_segformer / uda_segformer_breakdown / uda_segformer_calibrated /
   uda_segformer_card_vs_cpu: ``uda_rein_dinov2_segformer_512x512`` (one
   2B student pass) through the train CLI with an in-memory GTA-frame
   source (RCS statistics on disk) and Cityscapes-frame target:
   UDA_CLI_STEPS DACS steps with a checkpoint whose ema file holds the
   state's EMA, launches a step, the EMA's first two moves (alpha 0, then
   0.5), the loader's samples/s, steps/s, a profiled step's device time and
   idle share; pseudo_weight at the config's threshold (about 0 with
   seeded weights) and at one calibrated to the median of the teacher's
   top probability (pseudo_weight in PSEUDO_WEIGHT_RANGE, the mix.* losses
   and their gradient nonzero); one 256^2 DACS step card vs CPU (teacher
   argmax, pseudo_weight, losses, gradient cosine).
23. uda_m2f / uda_m2f_calibrated / uda_m2f_breakdown:
   ``uda_rein_dinov2_mask2former_512x512`` (two sequential student passes,
   the set loss scaled by the mean pixel weight): UDA_M2F_STEPS DACS steps
   through train_loop with the same checks, the teacher's launches (its
   no-grad pixel decoder on the fused deformable core) reported apart, a
   profiled step.
24. uda_hrda / uda_hrda_calibrated: ``uda_rein_dinov2_hrda_1024x1024``
   (two sequential passes, the HR crop's weight cut from its box):
   UDA_HRDA_STEPS DACS steps with the same checks.
25. ddp_world1: data parallelism (``parallel/mesh.py``) at world size 1 on
   NCCL: the headline's train CLI for DDP_STEPS steps without and with
   ``--distributed`` (torchrun's variables set for one rank) on an
   in-memory source at the crop size; the first step's losses bit-equal,
   later ones within DDP_LOSS_REL, the weights within AdamW's 2 lr a step;
   both runs' step times, a fixed batch's step with and without the group
   and the gradient all-reduce alone; the eval CLI plain and at
   ``--data-parallel 1`` from the run's checkpoint and backbone, equal
   metrics. The group is destroyed after.
26. kernel_attention_hm_d32: B5's D-32 instantiations (forward with and
   without the LSE, fused backward) at DINOhead's shapes
   (DINOHEAD_HM_SHAPES) against the plain versions, the dispatcher's
   route to them, times beside SDPA's and the bound.
27. dinohead_path / dinohead_train_card_vs_cpu: ``MultiScaleEncoderDecoder``
   + DINOhead (8 heads of 32) on LoRA DINOv2-L at full width: one 512 x
   1024 image through the context-conditioned slide card vs CPU, one bs2
   1024^2 step, B5's D-32 launches and the shapes they ran at; one 256^2
   step bf16 vs fp32.
28. remat: the headline's bs2 1024^2 step with ``remat=True`` against
   ``remat=False``: losses, LoRA gradient cosine, the recomputed blocks'
   launches, peak memory and time of each.
29. debug_grids: the train CLI with ``schedule.debug_interval=1`` for one
   step on the headline and on UDA SegFormer: the panels computed on the
   card, and whether a PNG was written (matplotlib present or not).

Every kernel's time is CUDA events around 10 back-to-back calls, the median
of 10 such windows after warm-up, beside its plain version's, the time of
one PyTorch library call that computes the same function (a yardstick the
port never calls) and its bound: the larger of the bytes it must move over
the card's memory rate and its operations over the card's peak rate for
their type (``bound``).

Then the nvidia-smi line, one JSON line of per-kernel results, and as the
last line ``{"ok": true, "device": {...}}``, printed only when every phase
passed. Any failure raises, so the exit code is non-zero and no result line
is printed; so does a machine without a CUDA card.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from vfmseg_tpu_torch import kernels
from vfmseg_tpu_torch.core.config import load_config
from vfmseg_tpu_torch.data.datasets import DGDataset, UDADataset
from vfmseg_tpu_torch.data.loader import InfiniteLoader, collate
from vfmseg_tpu_torch.data.synthetic import SyntheticDataset, synthetic_sample
from vfmseg_tpu_torch.data.transforms import TestPipeline, TrainPipeline
from vfmseg_tpu_torch.eval.compact import _bucket, window_confidence
from vfmseg_tpu_torch.eval.evaluator import (
    make_compact_ms_slide,
    make_logits_fn,
    make_shape_aware_predict_fn,
    stream_evaluate,
    unwrap_model,
)
from vfmseg_tpu_torch.eval.metrics import IoUAccumulator
from vfmseg_tpu_torch.eval.slide import (
    compute_slide_grid,
    confident_mask,
    extract_crops,
    ms_slide_inference,
)
from vfmseg_tpu_torch.kernels.time_hm_bwd import device_ms as profiled_ms
from vfmseg_tpu_torch.kernels.time_layer_norm import eager_and_graph_ms
from vfmseg_tpu_torch.kernels.time_qkv_fwd import (
    lse_agreement,
    lse_library_calls,
)
from vfmseg_tpu_torch.kernels.time_relpos import SHAPES as RELPOS_SHAPES
from vfmseg_tpu_torch.models import rng
from vfmseg_tpu_torch.models.heads import m2f_loss
from vfmseg_tpu_torch.models.heads.mask2former import _reference_points
from vfmseg_tpu_torch.models.build import (
    build_segmentor,
    compute_attn_impl,
    compute_dtype,
)
from vfmseg_tpu_torch.models.presets import (
    PREPROCESSOR,
    config,
    eva02_config,
    headline_config,
    mask2former_config,
    sam_config,
)
from vfmseg_tpu_torch.ops import attention as attention_mod
from vfmseg_tpu_torch.ops.attention import (
    attention_bwd_plain,
    attention_bwd_tm,
    attention_decomposed_plain,
    attention_fwd_lse_plain,
    attention_fwd_lse_tm,
    attention_hm_bwd,
    attention_hm_fwd,
    attention_plain,
    attention_qkv_rope_plain,
    attention_qkv_rope_tm,
    attention_qkv_tm,
    attention_relpos_hm,
    multi_head_attention,
)
from vfmseg_tpu_torch.ops.deform_attn import (
    ms_deform_attn_cuda,
    ms_deform_attn_levels,
    ms_deform_attn_plain,
    sample_cuda,
    sample_plain,
)
from vfmseg_tpu_torch.ops.norm import layer_norm_cuda, layer_norm_plain
from vfmseg_tpu_torch.ops.swiglu import (
    swiglu_gate_ln_cuda,
    swiglu_gate_ln_plain,
)
from vfmseg_tpu_torch.ops.resize import resize
from vfmseg_tpu_torch.ops.rope import (
    apply_rope_permuted,
    permuted_rope_tables,
    vit_rope_tables,
)
from vfmseg_tpu_torch.ops.window import (
    decomposed_rel_pos_bias_hm,
    decomposed_rel_pos_terms_hm,
)
from vfmseg_tpu_torch.ops.window_blend import (
    blend_windows_cuda,
    blend_windows_plain,
)
from vfmseg_tpu_torch.parallel import mesh
from vfmseg_tpu_torch.tools import test as test_cli
from vfmseg_tpu_torch.tools import train as train_cli
from vfmseg_tpu_torch.tools.test import evaluate_dataset
from vfmseg_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_npz_tree,
    load_pytree,
    save_pytree,
    trainable_state_dict,
)
from vfmseg_tpu_torch.train.loop import train_loop
from vfmseg_tpu_torch.train.state import create_train_state
from vfmseg_tpu_torch.train.step import (
    make_train_step,
    step_generators,
    sum_losses,
)
from vfmseg_tpu_torch.train.uda import (
    dacs_mix,
    init_ema,
    make_dacs_train_step,
    student_losses,
    teacher_logits,
)
from vfmseg_tpu_torch.weights import (
    flax_from_state_dict,
    init_params,
    state_dict_from_flax,
)

SEED = 0
N_IMAGES = 3
IMAGE_HW = (1024, 2048)
CHECK_HW = (512, 1024)
REPO = os.path.dirname(os.path.abspath(__file__))
TRAIN_WORK_DIR = os.path.join(REPO, "work_dirs", "chip_smoke_train")
TRAIN_STEPS = 8
TRAIN_CKPT_EVERY = 4
TRAIN_CHECK_HW = (256, 256)
TRAIN_CHECK_CROP = (128, 128)
# the train CLI (phase train_cli): the headline's config file through the
# port's loader, trained on in-memory synthetic samples at GTA's frame
# (1052 x 1914, 19 classes) through the config's own pipeline (resize to
# 2560 x 1440, a 1024^2 cat-max-ratio crop, flip, photometric distortion,
# RCS, 4 loader threads); checkpoints every 3 steps, validation and
# save_best at step 6 on one 1024 x 2048 image, then a resumed run to 8
TRAIN_CLI_CONFIG = os.path.join(REPO, "configs", "dg", "gta2citys",
                                "dg_lora_dinov2_ms_masked.py")
TRAIN_CLI_DIR = os.path.join(REPO, "work_dirs", "chip_smoke_train_cli")
TRAIN_CLI_SOURCE_HW = (1052, 1914)
TRAIN_CLI_SAMPLES = 8
TRAIN_CLI_STEPS = 6
TRAIN_CLI_RESUME_TO = 8
TRAIN_CLI_OPTIONS = ["schedule.log_interval=1",
                     "schedule.checkpoint_interval=3",
                     "schedule.val_interval=6",
                     "schedule.save_best=citys_mIoU", "data.val_max_images=1"]
LOADER_SAMPLES = 16

KERNEL_NAMES = [k.name for k in kernels.KERNELS]
# (group, substring of the device kernel's name) for the profiler
# breakdowns; B2 and B3 are one template (kWithLse); B2-RoPE's entry
# launches its rotation pass (group attention_qkv_rope) and then B2's
# kernel (counted in group attention_qkv);
# SAM's bias route runs B5's D = 80, bf16-bias instantiations (<80, 1>);
# both B5 backward entries end with the dq rounding kernel, and B3's
# backward (B4's function) runs on B5's fused backward without a bias
KERNEL_GROUPS = [("attention_hm_bias_fwd", "attention_hm_fwd_kernel<80, 1>"),
                 ("attention_hm_bias_bwd", "attention_hm_bwd_kernel<80, 1>"),
                 ("attention_hm_fwd", "attention_hm_fwd_kernel"),
                 ("attention_hm_bwd", "attention_hm_bwd_kernel"),
                 ("attention_hm_bwd_dq_round", "attention_hm_dq_round_kernel"),
                 ("attention_qkv", "attention_qkv_kernel<false>"),
                 ("attention_qkv_rope", "rope_rotate_kernel"),
                 ("attention_fwd_lse", "attention_qkv_kernel<true>"),
                 ("attention_relpos", "attention_relpos"),
                 ("window_blend", "window_blend_kernel"),
                 ("deform_attn", "deform_sample_kernel_fused"),
                 ("deform_sample", "deform_sample_kernel"),
                 ("swiglu_gate_ln", "swiglu_gate_ln"),
                 ("layer_norm", "layer_norm")]


def _counts(**nonzero) -> dict:
    return {name: nonzero.get(name, 0) for name in KERNEL_NAMES}


# Each path's launches per 1024x2048 image: stage-1 ViT (24 blocks; SAM 32),
# refine ViT over all 18 crops in one batch (24 blocks; SAM 32), VFMHead
# decoder (3 blocks, self- and cross-attention); DINOv2, SAM and EVA02
# blocks run 2 LayerNorms, and EVA02's SwiGLU its gate and sub-LN in one
# kernel (swiglu_gate_ln; its training route runs B1 for the sub-LN); every
# SAM block, windowed or global, runs B7 once, or on the bias route
# (sam_bias: compute.attn_impl = "pallas_bias") B5's bias forward once.
# Mask2Former (m2f) slides 18 crops of 512 at stride 341 through one ViT
# batch (24 blocks: 48 LN, 24 B2); its pixel decoder runs 6 layers of 2 LN
# and one fused deformable core (deform_attn, no gradient wanted) each, its
# decoder 9 layers of 3 LN plus the decoder
# norm 10 times (the 9 attention masks and the last prediction); its masked
# attention is plain PyTorch math. B2-RoPE's entry launches its rotation
# pass and then B2's kernel: the pair counts once, under attention_qkv_rope,
# and not under attention_qkv, as B5's backward counts its dq rounding.
PER_IMAGE = {
    "dinov2": _counts(layer_norm=48 + 48 + 9, attention_qkv=24 + 24 + 6),
    "eva02": _counts(layer_norm=48 + 48 + 9, swiglu_gate_ln=24 + 24,
                     attention_qkv_rope=24 + 24, attention_qkv=6),
    "sam": _counts(layer_norm=64 + 64 + 9, attention_relpos=32 + 32,
                   attention_qkv=6),
    "sam_bias": _counts(layer_norm=64 + 64 + 9,
                        attention_hm_bias_fwd=32 + 32, attention_qkv=6),
    "m2f": _counts(layer_norm=48 + 6 * 2 + 9 * 3 + 10, attention_qkv=24,
                   deform_attn=6),
    # the Rein model's slide eval: the same kernels as m2f (the adapter and
    # the pyramid's resizes are PyTorch's GEMMs and F.interpolate)
    "rein": _counts(layer_norm=48 + 6 * 2 + 9 * 3 + 10, attention_qkv=24,
                    deform_attn=6),
    # LoRA CLIP-L in the MsVFM scheme: DINOv2's kernels, each ViT call one
    # LayerNorm more (ln_pre)
    "clip": _counts(layer_norm=49 + 49 + 9, attention_qkv=24 + 24 + 6),
    # Rein CLIP-L with its FPN under the Rein Mask2Former head: one ViT call
    # over the 18 crops (49 LN, 24 B2; the FPN's norms are GroupNorm and
    # BatchNorm), the head as in m2f
    "rein_clip_m2f": _counts(layer_norm=49 + 6 * 2 + 9 * 3 + 10,
                             attention_qkv=24, deform_attn=6),
    # HRDA's slide eval (1024 windows at stride 682: 3 windows): one ViT
    # call over the 3 windows' LR views (512^2) and one over their 27 HR
    # crops (512 at stride 256); its two heads have no LayerNorm
    "hrda": _counts(layer_norm=2 * 48, attention_qkv=2 * 24),
    # Rein DINOv2 + SegformerHead, slide at 512 / 341: one ViT call
    "segformer": _counts(layer_norm=48, attention_qkv=24),
    # MiT-B5 + DAFormer (whole): per stage the patch embedding's LN, 2 LN a
    # block, the sr LayerNorm in each block of stages 1-3 (sr 8, 4, 2) and
    # the closing LN: (1+6+3+1) + (1+12+6+1) + (1+80+40+1) + (1+6+1) = 161;
    # the 49 blocks of stages 1-3 attend over reduced keys on B5's forward,
    # the 3 of stage 4 on B2 off the fused q|kv product
    "mit": _counts(layer_norm=161, attention_hm_fwd=49, attention_qkv=3),
}
# Each path's launches per train step: one ViT pass over the 2B batch of
# both scale views (24 blocks; SAM 32), the VFMHead decoder (3 blocks); every
# attention has a backward kernel except B7, whose backward recomputes
# through the plain version (the bias route runs B5's two bias entries, the
# forward and the fused backward); B3's backward is B5's fused backward
# (attention_hm_bwd) over token-major views; every LayerNorm backward is
# plain torch.
PER_STEP = {
    "dinov2": _counts(layer_norm=48 + 9, attention_fwd_lse=24 + 6,
                      attention_hm_bwd=24 + 6),
    "eva02": _counts(layer_norm=72 + 9, attention_fwd_lse=6,
                     attention_hm_fwd=24, attention_hm_bwd=24 + 6),
    "sam": _counts(layer_norm=64 + 9, attention_relpos=32,
                   attention_fwd_lse=6, attention_hm_bwd=6),
    "sam_bias": _counts(layer_norm=64 + 9, attention_hm_bias_fwd=32,
                        attention_hm_bias_bwd=32,
                        attention_fwd_lse=6, attention_hm_bwd=6),
    # The encoder-decoder steps, one ViT pass over the batch of 2: with
    # Mask2Former 97 LayerNorms as at inference (the decoder norm predicts
    # every one of the 10 stages), B8 18 times forward (its backward
    # recomputes through the plain version). With only the reins training
    # (rein), nothing in block 0 needs a gradient (its input is the frozen
    # patch embedding; the first adapter acts after it), so autograd records
    # no attention there and the block takes B2: 1 B2, 23 B3 and 23 fused
    # backward; with LoRA on every qkv (lora_m2f, lora_linear) all 24
    # blocks train. The LinearHead has no LayerNorm.
    "rein": _counts(layer_norm=97, attention_qkv=1, attention_fwd_lse=23,
                    attention_hm_bwd=23, deform_sample=18),
    "lora_m2f": _counts(layer_norm=97, attention_fwd_lse=24,
                        attention_hm_bwd=24, deform_sample=18),
    "lora_linear": _counts(layer_norm=48, attention_fwd_lse=24,
                           attention_hm_bwd=24),
    # LoRA CLIP-L (MsVFM): the LoRA targets proj/fc1/fc2, so block 0's qkv
    # input (ln_pre of the frozen embeddings) needs no gradient and its
    # attention takes B2; the other 23 and the decoder's 6 train
    "clip": _counts(layer_norm=49 + 9, attention_qkv=1,
                    attention_fwd_lse=23 + 6, attention_hm_bwd=23 + 6),
    # Rein CLIP-L + FPN + Rein Mask2Former (reins and fpn train): as rein,
    # with ln_pre
    "rein_clip_m2f": _counts(layer_norm=49 + 49, attention_qkv=1,
                             attention_fwd_lse=23, attention_hm_bwd=23,
                             deform_sample=18),
    # HRDA and SegFormer on Rein DINOv2 (only the reins train): HRDA's LR
    # view and HR crop (both 512^2) through two ViT calls, as in JAX
    "hrda": _counts(layer_norm=2 * 48, attention_qkv=2,
                    attention_fwd_lse=2 * 23, attention_hm_bwd=2 * 23),
    "segformer": _counts(layer_norm=48, attention_qkv=1,
                         attention_fwd_lse=23, attention_hm_bwd=23),
    # MiT-B5 (everything trains): B5's forward with the LSE and its fused
    # backward in stages 1-3, B3 and the fused backward in stage 4
    "mit": _counts(layer_norm=161, attention_hm_fwd=49, attention_fwd_lse=3,
                   attention_hm_bwd=49 + 3),
    # DomainGeneral with the mask branch (dg_lora_dinov2_ms_masked_
    # consistency): the headline's step twice, the second call on the
    # jittered, blurred, block-masked batch; the augmentations are PyTorch
    "dg": _counts(layer_norm=2 * (48 + 9), attention_fwd_lse=2 * (24 + 6),
                  attention_hm_bwd=2 * (24 + 6)),
    # The DACS steps. The teacher (the student's ViT and the EMA head, in
    # eval mode, no graph) runs encode_decode on the 2 target images: every
    # block on B2. uda_segformer (exactly EncoderDecoder) then runs one
    # student pass over the 2B = 4 source and mixed images, as the rein
    # step (block 0 on B2); uda_m2f and uda_hrda run two student passes
    # (source, then mixed), each as its DG step. The HRDA teacher is
    # HRDA's slide: one ViT call over the 2 LR views and one over the 18 HR
    # crops of 512 at stride 256.
    "uda_segformer": _counts(layer_norm=48 + 48, attention_qkv=24 + 1,
                             attention_fwd_lse=23, attention_hm_bwd=23),
    "uda_m2f": _counts(layer_norm=97 + 2 * 97, attention_qkv=24 + 2,
                       attention_fwd_lse=2 * 23, attention_hm_bwd=2 * 23,
                       deform_attn=6, deform_sample=2 * 18),
    "uda_hrda": _counts(layer_norm=2 * 48 + 2 * 2 * 48,
                        attention_qkv=2 * 24 + 2 * 2,
                        attention_fwd_lse=2 * 2 * 23,
                        attention_hm_bwd=2 * 2 * 23),
}
# the encoder-decoder configs trained for ENCDEC_STEPS steps (phase
# encdec_train) and the Rein model of phases rein_*
ENCDEC_CONFIGS = (("lora_m2f", "dg_lora_dinov2_mask2former"),
                  ("lora_linear", "dg_lora_dinov2_linearhead"))
ENCDEC_STEPS = 3
REIN_CONFIG = "dg_rein_dinov2_mask2former"
# this slice's models: LoRA CLIP-L (MsVFM), Rein CLIP-L under the Rein
# Mask2Former head, HRDA and SegFormer on Rein DINOv2-L, MiT-B5 + DAFormer's
# separable-ASPP head (a model base: it names no data, so the smoke gives
# it batch 2); each is served and trained for SLICE_STEPS steps
CLIP_CONFIG = "dg_lora_clip_ms_masked"
REIN_CLIP_CONFIG = "rein_clip_l_mask2former_512x512_bs1x4"
HRDA_CONFIG = "dg_rein_dinov2_hrda_1024x1024"
SEGFORMER_CONFIG = "dg_rein_dinov2_segformer"
MIT_CONFIG = os.path.join(REPO, "configs", "_base_", "models",
                          "daformer_sepaspp_mitb5.py")
MIT_HW = (512, 1024)
SLICE_STEPS = 3
# B5 at MiT-B5's train shapes (bs 2, 512^2 crops): stages 1-3 attend from
# 128^2, 64^2 and 32^2 queries to 16^2 keys (sr 8, 4, 2), heads 1, 2, 5,
# head dim 64; k and v are views of one kv projection: (B, H, Nq, Nk)
DG_CONFIG = "dg_lora_dinov2_ms_masked_consistency"
DG_STEPS = 3
UDA_SEGFORMER_CONFIG = "uda_rein_dinov2_segformer_512x512"
UDA_M2F_CONFIG = "uda_rein_dinov2_mask2former_512x512"
UDA_HRDA_CONFIG = "uda_rein_dinov2_hrda_1024x1024"
UDA_CLI_DIR = os.path.join(REPO, "work_dirs", "chip_smoke_uda_cli")
UDA_CLI_STEPS = 3
UDA_M2F_STEPS = 3
UDA_HRDA_STEPS = 2
TARGET_HW = (1024, 2048)  # Cityscapes' frame
UDA_CHECK_HW = (256, 256)
# the calibrated pseudo_threshold's share of confident target pixels
PSEUDO_WEIGHT_RANGE = (0.3, 0.7)
MIT_HM_SHAPES = [(2, 1, 16384, 256), (2, 2, 4096, 256), (2, 5, 1024, 256)]
# A11 + A13 (phases 25-29): data parallelism at world size 1 on NCCL, B5 at
# head dim 32 under DINOhead, remat and the debug grids
DDP_DIR = os.path.join(REPO, "work_dirs", "chip_smoke_ddp")
DDP_STEPS = 3
DDP_SAMPLES = 4
DDP_EVAL_IMAGES = 2
DDP_TIMED_STEPS = 5
# Steps after the first of the two runs (with and without the process
# group): B5's fused backward adds dq over key tiles with fp32 atomics in
# an order that changes from run to run, so the gradients, and from step 2
# the weights and losses, differ in rounding. AdamW's first steps move a
# weight by about lr whatever its gradient's size, so a rounding-noise
# gradient can flip a step: |delta p| <= 2 lr a step (+ decay).
DDP_LOSS_REL = 1e-2
# DINOhead's attention (8 heads of 32 over the fused 32 x 32 grid of a 512^2
# crop): the inference's three refine windows of a 512 x 1024 image, the bs2
# train step's HR crops at 1024^2, the card-vs-CPU step's 128^2 crops (8 x 8)
DINOHEAD_HM_SHAPES = [(3, 8, 1024, 1024), (2, 8, 1024, 1024), (2, 8, 64, 64)]
DINOHEAD_HW = (512, 1024)
DINOHEAD_TRAIN_HW = (1024, 1024)

# The headline's compact gated engine: launches per stage-1 call (the ViT
# over a batch of whole images at 512x1024) and per finish step that refines
# k > 0 windows (the ViT and the VFMHead decoder over the k windows, then one
# B9); a finish step with k = 0 launches nothing.
COMPACT_STAGE1 = _counts(layer_norm=48, attention_qkv=24)
COMPACT_FINISH = _counts(layer_norm=48 + 9, attention_qkv=24 + 6,
                         window_blend=1)
# B9 at the compact path's shapes: (label, images in the base, windows
# needed, refine batch k, base dtype). The engine blends into an fp32 base
# (the TPU kernel's dtype); the JAX engine's bf16 base is checked beside
# it. The per-image predictor at the bucket for all 18 windows (2 pad rows)
# and at an image of the calibrated gate (3 needed, bucket 4); a stream
# group of 8 images at 0.8 skip (29 of 144 windows, bucket 30) and with
# every window refined (144, bucket 160).
BLEND_CASES = [("per_image_all", 1, 18, 20, torch.float32),
               ("per_image_all_bf16", 1, 18, 20, torch.bfloat16),
               ("per_image_skip", 1, 3, 4, torch.float32),
               ("stream_skip", 8, 29, 30, torch.float32),
               ("stream_skip_bf16", 8, 29, 30, torch.bfloat16),
               ("stream_all", 8, 144, 160, torch.float32)]
TARGET_SKIP = 0.8
COMPACT_IMAGES = 16
COMPACT_GROUP = 8
COMPACT_DENSE_IMAGES = 4
CLI_IMAGES = 4
# compact against dense on the card, one bf16 model: argmax agreement and
# the q99 logit drift relative to the dense logits' q99 magnitude. Both
# take the same stage-1 map and refine the same windows and both blend in
# fp32 (the dense path sums the windows and scales, the compact one scales
# each delta and adds: fp32 rounding in another order), but the refine
# batch differs (the bucket's k windows against all 18), and the refine
# head's bf16 GEMMs may round another way at another batch size.
COMPACT_AGREE = 0.999
COMPACT_DRIFT_Q99 = 1e-3
# the stream (stage 1 at batch 8) against the per-image compact predictor
# (stage 1 at batch 1): the same gate and blend, stage 1 and the refine
# batch in other shapes
STREAM_AGREE = 0.999

# (shape, eps, dtype) of every LayerNorm on the DINOv2 path, then the fp32
# input the kernel also takes
LN_CASES = [((1, 2049, 1024), 1e-6, torch.bfloat16),
            ((18, 1025, 1024), 1e-6, torch.bfloat16),
            ((18, 1024, 256), 1e-5, torch.bfloat16),
            ((18, 1025, 1024), 1e-6, torch.float32)]
# MiT-B5's LayerNorms over [B, H, W, C] maps at a 512x1024 image: each
# stage's patch-embedding, block and closing norms (C 64, 128, 320, 512 are
# 8, 16, 40 and 64 bf16 vectors of 8 for a warp's 32 lanes: at C 64 24
# lanes hold none, at C 320 a lane holds 1 or 2), then the sr norms of
# stages 1-3 over the reduced 16x32 maps
MIT_LN_CASES = [((1, 128, 256, 64), 1e-6, torch.bfloat16),
                ((1, 64, 128, 128), 1e-6, torch.bfloat16),
                ((1, 32, 64, 320), 1e-6, torch.bfloat16),
                ((1, 16, 32, 512), 1e-6, torch.bfloat16),
                ((1, 16, 32, 64), 1e-6, torch.bfloat16),
                ((1, 16, 32, 128), 1e-6, torch.bfloat16),
                ((1, 16, 32, 320), 1e-6, torch.bfloat16)]
# EVA02's SwiGLU sub-LN at the refine batch, stage 1 and the train batch
# (rows start 0, 4, 8 or 12 bytes past a 16-byte boundary, in turn: a head
# of 0, 6, 4 or 2 elements before the 16-byte body), then an odd width and
# fp32 at 2730 (too wide for a warp's registers: the block-per-row kernel),
# both off the path
LN_EVA02_CASES = [((18 * 1025, 2730), 1e-6, torch.bfloat16),
                  ((2049, 2730), 1e-6, torch.bfloat16),
                  ((4 * 1025, 2730), 1e-6, torch.bfloat16),
                  ((3, 77, 341), 1e-6, torch.bfloat16),
                  ((4 * 1025, 2730), 1e-6, torch.float32)]
# EVA02's SwiGLU gate and sub-LN, (rows, H, Hp, dtype): the padded eval
# route at the refine batch and stage 1, an aligned width (EVA02-B's 2048),
# fp32 (8 vectors a thread), a bf16 row past a block's registers (the
# block-per-row kernel)
SWIGLU_CASES = [(18 * 1025, 2730, 2736, torch.bfloat16),
                (2049, 2730, 2736, torch.bfloat16),
                (2049, 2048, 2048, torch.bfloat16),
                (65, 2730, 2736, torch.float32),
                (9, 9000, 9000, torch.bfloat16)]
# Off the paths, (shape, eps, dtype, elements x starts past a 16-byte
# boundary): the tail alone (C 7 < one vector), an odd width (every head
# length in turn), one row, 2730 with x 2 and 6 bytes off (heads of 7 and 5
# then), 1024 with x 10 bytes off (the staged weights at an aligned width),
# fp32 at 256 (weights in registers) and at 2049 with x 4 bytes off, and a
# bf16 row too wide for a warp's registers (4096: the block-per-row kernel)
LN_OFF_PATH_CASES = [((5, 7), 1e-6, torch.bfloat16, 0),
                     ((33, 2049), 1e-6, torch.bfloat16, 0),
                     ((1, 2730), 1e-6, torch.bfloat16, 0),
                     ((9, 2730), 1e-6, torch.bfloat16, 1),
                     ((9, 2730), 1e-6, torch.bfloat16, 3),
                     ((7, 1024), 1e-6, torch.bfloat16, 5),
                     ((18, 1024, 256), 1e-5, torch.float32, 0),
                     ((40, 2049), 1e-6, torch.float32, 1),
                     ((3, 4096), 1e-6, torch.bfloat16, 0)]
# (B, N, H, fused qkv?) of every attention on the DINOv2 inference path,
# then cases off the path: an odd head count with both tiles ragged, a
# single key step whose second 64-row slab lies past N, a 16-key tail right
# after the first step, and N = 16 (one step, a 16-key box); head dim 64
OFF_PATH_ATTN_SHAPES = [(2, 77, 3, True), (2, 64, 2, True),
                        (2, 144, 2, False), (3, 16, 1, False)]
# MiT-B5's stage 4 at a 512x1024 image: q and kv weights concatenated into
# one fused qkv product over the 16x32 grid, 8 heads
MIT_ATTN_SHAPE = (1, 512, 8, True)
# the DACS teacher's batch of two 512^2 target images (uda_segformer,
# uda_m2f: encode_decode of the Rein ViT in eval mode, so B2)
TEACHER_ATTN_SHAPE = (2, 1025, 16, True)
ATTN_SHAPES = [(1, 2049, 16, True), (18, 1025, 16, True),
               (18, 1024, 8, False), *OFF_PATH_ATTN_SHAPES, MIT_ATTN_SHAPE,
               TEACHER_ATTN_SHAPE]
# (B, N, H, (gh, gw), v apart?) of the RoPE attention: EVA02's stage 1
# (32x64 grid) and refine batch (32x32) off one fused qkv, then cases off
# the path: a ragged odd-head case (4x19 grid), N 17 (one step of 17 keys),
# N 129 (a 16-key tail step after a whole one, and consumer 1 idle on the
# last query tile), batch 1 at N 145 (a whole last step of 17 keys, consumer
# 1 idle), and v a tensor of its own (token stride H*64 beside the qkv's
# 3*H*64 for q and k); each with the cls token's identity row
ROPE_SHAPES = [(1, 2049, 16, (32, 64), False),
               (18, 1025, 16, (32, 32), False),
               (2, 77, 3, (4, 19), False), (2, 17, 3, (4, 4), False),
               (2, 129, 2, (8, 16), False), (1, 145, 2, (12, 12), False),
               (2, 77, 3, (4, 19), True)]
# (atol, rtol): bf16 output rounding and another summation order; in fp32
# only the summation order
LN_TOL = {torch.bfloat16: (3e-2, 1e-2), torch.float32: (1e-4, 1e-5)}
# P rounds to bf16 before P.V, and the accumulation order differs; with RoPE
# the rotated q and k also round to bf16 in both versions, in another order
ATTN_ATOL = 1e-2
# (B, N, H, fused qkv?) of the DINOv2 training attention: the ViT over both
# scale views, the decoder, and ragged cases off the path (an odd head count,
# then the three single-step and tail cases above); then MiT-B5's stage 4 in
# its bs 2 step at 512^2 crops (a 16x16 grid off the fused q|kv product)
TRAIN_ATTN_SHAPES = [(4, 1025, 16, True), (2, 1024, 8, False),
                     (3, 77, 3, True), *OFF_PATH_ATTN_SHAPES[1:],
                     (2, 256, 8, True)]
# (B, H, Nq, Nk) of the head-major attention: EVA02's ViT over both scale
# views, then a ragged Nq != Nk case
HM_SHAPES = [(4, 16, 1025, 1025), (3, 3, 77, 130)]
# B6's function computed by B5's forward entry with the LSE off, at the
# shape of a head-major primal over ViT-L's refine batch: (B, H, N)
B6_SHAPE = (18, 16, 1025)
# B5 with a bias at SAM's six path shapes (RELPOS_SHAPES: windows and
# global blocks of stage 1, the refine batch and the train step; head dim
# 80, q, k, v views of one fused qkv tensor, the bf16 [B, H, N, N] bias that
# decomposed_rel_pos_bias_hm builds), then a ragged Nq != Nk case off the
# path with a bias broadcast over the heads (stride 0): (path, B, H, Nq, Nk)
HM_BIAS_RAGGED = ("off_path_ragged", 3, 3, 77, 130)
# B8 at the pixel decoder's eval shape: one level of a slide call (18 crops
# x 8 heads, a 32x32 level, 32 channels) sampled at 4 points x 3072
# queries; (B, H, W, C, N)
DEFORM_SHAPE = (144, 32, 32, 32, 12288)
# off the path: a narrow ragged case (5 channels, 40 samples: one element
# an access), 64 channels (8 threads a sample in bf16), and 36 channels on a
# value whose data starts 8 bytes past a 16-byte boundary (8-byte accesses)
# B8 at the Rein model's pyramid (resize_feat at a 512 crop: the pixel
# decoder's levels are 64^2, 32^2, 16^2, 5376 queries x 4 points a level
# call): the train step's 2 crops x 8 heads and the slide batch's 18 x 8
DEFORM_REIN = [(f"rein_{kind}_{side}", (b_, side, side, 32, 4 * 5376))
               for kind, b_ in (("train", 16), ("eval", 144))
               for side in (64, 32, 16)]
DEFORM_OFF_PATH = (3, 7, 9, 5, 40)
DEFORM_WIDE = (6, 16, 16, 64, 1000)
DEFORM_MISALIGNED = (5, 9, 11, 36, 333)
# B8 against the fp32 plain version on the same inputs: the kernel rounds
# once to bf16 at the end (|err| <= 2^-9 |ref|; 2^-8 leaves room for the
# fp32 sums' order), and in fp32 only the order of 7 fp32 operations differs
DEFORM_TOL = {torch.bfloat16: (1e-6, 2.0 ** -8), torch.float32: (1e-5, 1e-6)}
# The fused deformable core (csrc/deform_attn.cu) at Rein's slide: one
# encoder layer over 18 crops, 8 heads of 32, levels 16^2/32^2/64^2, 4
# points, 5376 queries (the levels' pixels, their centres as reference
# points), in bf16 (the path) and fp32; a train batch of 2 crops; then off
# the path: 1 level and 1 point, 4 levels, head dims 8, 64 and 4, a head of
# 5 channels in 3 heads (one element an access), a value 8 bytes off a
# 16-byte boundary, levels x points = 32, and 16 heads. Off the path the
# queries are fewer than the tokens and their reference points random.
# (label, B, Nq, level shapes, heads, d, points, dtype, value's offset in
# elements)
REIN_LEVELS = ((16, 16), (32, 32), (64, 64))
DEFORM_ATTN_CASES = [
    ("rein_slide", 18, 5376, REIN_LEVELS, 8, 32, 4, torch.bfloat16, 0),
    ("rein_slide_fp32", 18, 5376, REIN_LEVELS, 8, 32, 4, torch.float32, 0),
    ("rein_train_batch", 2, 5376, REIN_LEVELS, 8, 32, 4, torch.bfloat16, 0),
    ("off_path_1level_1point", 3, 333, ((5, 7),), 8, 32, 1,
     torch.bfloat16, 0),
    ("off_path_4levels", 2, 101, ((3, 4), (6, 8), (12, 16), (24, 32)), 8,
     32, 4, torch.bfloat16, 0),
    ("off_path_d8", 2, 77, ((4, 4), (8, 8), (16, 16)), 8, 8, 4,
     torch.bfloat16, 0),
    ("off_path_d64_fp32", 2, 77, ((4, 4), (8, 8), (16, 16)), 4, 64, 4,
     torch.float32, 0),
    ("off_path_d4", 2, 50, ((4, 4), (8, 8), (16, 16)), 8, 4, 4,
     torch.bfloat16, 0),
    ("off_path_d5", 2, 50, ((4, 4), (8, 8)), 3, 5, 2, torch.bfloat16, 0),
    ("off_path_misaligned", 2, 90, ((4, 4), (8, 8), (16, 16)), 8, 32, 4,
     torch.bfloat16, 4),
    ("off_path_32_samples", 1, 40, ((6, 6), (3, 3)), 1, 32, 16,
     torch.float32, 0),
    ("off_path_16heads", 2, 60, ((3, 4), (6, 8), (12, 16), (24, 32)), 16,
     16, 4, torch.bfloat16, 0),
]
# the fused core against its twin in fp32 on the same inputs: in bf16 the
# output's one rounding (2^-9 of it) and sums in another order, in fp32
# sums in another order
DEFORM_ATTN_TOL = {torch.bfloat16: (1e-5, 2.0 ** -8),
                   torch.float32: (1e-5, 1e-5)}
# LSE: fp32 sums in another order, fast exp/log against exp/log
LSE_ATOL = 1e-3
# dq/dk/dv, as max abs error over max |reference|: P and dS round to bf16
# before their products (2^-9 each), the outputs are bf16, and delta comes
# from the bf16 O, against an fp32 autograd reference
GRAD_REL = 2e-2
# PARITY.md's bf16 feature budget (2e-2), widened for 24 blocks + two heads
DRIFT_Q99 = 5e-2
ARGMAX_AGREE = 0.98
# Mask2Former, card (bf16) vs CPU (fp32): each decoder layer attends where
# sigmoid(mask logit) >= 0.5, so a bf16 mask logit near 0 flips a pixel of
# the next layer's attention mask and moves that query; with seeded weights
# the 20 class scores per query are near-uniform, so the argmax over the
# summed class x mask scores has thin margins. q99 drift 1e-1 (a toy
# DINOv2 + Mask2Former in bf16 against fp32 on the CPU drifted 7.7e-2),
# argmax agreement 0.95.
M2F_DRIFT_Q99 = 1e-1
M2F_ARGMAX_AGREE = 0.95
# Every card-vs-CPU check also reports the argmax agreement over the pixels
# whose CPU top-2 logit gap is at least CLEAR_GAP, where a flip needs a
# logit error of half the gap. Measured on an NVIDIA H100 80GB HBM3 at
# 700 W: LoRA CLIP-L's seeded-weight logits are twice as tied as DINOv2's
# (18.7% of its pixels lie within 0.1 of a tie against DINOv2's 9.0%), and
# it agrees at 99.993% beyond that gap (DINOv2 99.9996%): its flips are
# near-ties. At DINOv2's rate of flips per near-tie pixel (13%) its
# whole-image agreement would be 97.6%: CLIP is held to 0.97 over all
# pixels and 0.999 beyond CLEAR_GAP.
CLEAR_GAP = 0.1
CLIP_ARGMAX_AGREE = 0.97
CLEAR_AGREE = 0.999
# one train step, bf16 card vs fp32 CPU: each loss entry within 3e-2
# relative (the same bf16 drift through 24 blocks and two heads); the
# flattened LoRA gradient within cosine 0.98 of the CPU's (bf16 activations
# and bf16 attention gradients through 24 blocks of backward), and its norm
# and the step's grad_norm within 5e-2 relative (a uniform scale, which the
# cosine cannot see)
TRAIN_LOSS_REL = 3e-2
TRAIN_GRAD_COS = 0.98
TRAIN_GRAD_NORM_REL = 5e-2

# The Mask2Former step, bf16 card vs fp32 CPU, the same point draws. The
# matching compares costs that seeded weights leave close together (the
# class scores of 100 queries are near-uniform and their masks alike), and
# the card's bf16 mask logits (2^-9 relative) reorder costs that lie within
# their rounding: a flipped near-tie is a matching of (near) equal cost.
# So the matchings are held by cost, not by identity: each card matching,
# priced by the CPU's fp32 costs, must cost within 2e-2 of the CPU's
# optimum (the bf16 cost error through the sampled BCE and dice terms).
# The share of equal matchings and of equal (stage, image, class) slots is
# reported with no floor: the first run on the card found 1 of 20
# matchings equal at an excess cost of 1.8e-3 (PERF.md §6). A
# flipped stage hands a class to another query whose CE and mask terms
# differ: the total loss within 5e-2, each entry within 1e-1, the adapter
# gradient's cosine >= 0.9 and grad_norm within 1e-1.
# One DACS step, bf16 card vs fp32 CPU, the same host draws (ClassMix,
# jitter, blur) at a pseudo_threshold set to the median of the CPU
# teacher's top probability. The teacher's argmax over all pixels >= 97%
# and >= 99.9% where the CPU's top-2 log-probability gap is at least
# CLEAR_GAP (CLIP's limits: the first card run read 97.63% over all
# pixels for the seeded Rein SegFormer at 256^2, against the inference
# checks' 98%, while its losses agreed within 1e-4 and its gradient at
# cosine 0.99987: the flips are the seeded head's near-ties);
# pseudo_weight within 2e-2 (a share of pixels: those whose top
# probability the bf16 drift carries across the threshold); each loss
# entry within 3e-2 relative and the trainable gradient's cosine >= 0.98
# (TRAIN_*: the train step's drift; the mixed loss also reads the few
# flipped pseudo-labels).
TEACHER_AGREE = CLIP_ARGMAX_AGREE
PSEUDO_WEIGHT_ABS = 2e-2

SET_MATCH_EXCESS = 2e-2
SET_TOTAL_REL = 5e-2
SET_LOSS_REL = 1e-1
SET_GRAD_COS = 0.9
SET_GRAD_NORM_REL = 1e-1

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# HBM bandwidth, dense bf16 tensor-core rate, fp32 rate outside the tensor
# cores. A card set below 700 W reaches less.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16_tensor": 989e12, "fp32": 67e12}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def time_ms(fn, reps: int = 10, inner: int = 10, warmup: int = 3) -> float:
    """Device time of one call, by CUDA events: the median over ``reps``
    windows of ``inner`` back-to-back calls each, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def bound(bytes_moved: float, ops: float, kind: str) -> dict:
    """The least time the card could take: the bytes the function must move
    (each input read once, each output written once) over the memory rate,
    or its operations over the peak rate of their type, whichever is
    larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[kind]
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=bytes_moved, ops=ops, ops_kind=kind)


def ln_bound(shape, dtype) -> dict:
    """LayerNorm: x read and y written once, fp32 weight and bias read once;
    ~8 fp32 operations an element (sum, centre, square, sum, scale, affine)."""
    numel = int(np.prod(shape))
    item = torch.empty((), dtype=dtype).element_size()
    return bound(2 * numel * item + 2 * shape[-1] * 4, 8 * numel, "fp32")


def attn_bound(b, h, nq, nk, products, reads, writes, rows, d=64,
               extra_bytes=0) -> dict:
    """Attention at head dim ``d`` in bf16: ``products`` matrix products of
    2*Nq*Nk*d operations per head; ``reads``/``writes`` counts of
    [*, N, H*d] bf16 tensors at Nq (or Nk for k/v), given as their lengths;
    ``rows`` fp32 [B, H, Nq] vectors (LSE, delta) moved; ``extra_bytes``
    for other inputs (B7's rel terms)."""
    ops = products * 2.0 * b * h * nq * nk * d
    per_token = b * h * d * 2
    bytes_moved = ((sum(reads) + sum(writes)) * per_token
                   + rows * b * h * nq * 4 + extra_bytes)
    return bound(bytes_moved, ops, "bf16_tensor")


def graph_ms(fn, dev) -> float:
    """The time of one call of ``fn`` with no host work between calls: 10
    calls captured in a CUDA graph, the median of 10 replays
    (``time_layer_norm.eager_and_graph_ms``). Events around eager calls
    count the host's gaps when a call's host work outlasts its kernel."""
    return eager_and_graph_ms(fn, dev)["graph_ms"]


def sdpa_fwd(q, k, v, scale):
    """The library yardstick: one ``F.scaled_dot_product_attention`` call
    over [B, H, N, 64] views."""
    return F.scaled_dot_product_attention(q, k, v, scale=scale)


def sdpa_bwd_fn(q, k, v, dout, scale):
    """The library yardstick of a backward: autograd through one
    ``F.scaled_dot_product_attention`` call, computing dq, dk and dv."""
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, scale=scale)
    return lambda: torch.autograd.grad(out, (qs, ks, vs), dout,
                                       retain_graph=True)


def sdpa_fwd_bwd_fn(q, k, v, dout, scale):
    """Autograd's forward and backward through one
    ``F.scaled_dot_product_attention`` call as one function, which a CUDA
    graph can capture whole (its backward runs on the forward's stream)."""
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))

    def run():
        out = F.scaled_dot_product_attention(qs, ks, vs, scale=scale)
        return torch.autograd.grad(out, (qs, ks, vs), dout)
    return run


def sdpa_bias_bwd_fn(q, k, v, bias, dout, scale):
    """The library yardstick of the bias route's backward: autograd through
    one ``F.scaled_dot_product_attention`` call with a float ``attn_mask``,
    computing dq, dk, dv and dbias."""
    qs, ks, vs, bs = (t.detach().requires_grad_(True) for t in (q, k, v,
                                                                 bias))
    out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bs,
                                         scale=scale)
    return lambda: torch.autograd.grad(out, (qs, ks, vs, bs), dout,
                                       retain_graph=True)


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], tf32_matmul=False, tf32_cudnn=False)
    return dict(smi=smi)


def ptxas_by_kernel(log: str, marker: str) -> dict:
    """ptxas' registers, spills and static shared memory of each compiled
    kernel whose (mangled) name contains ``marker``, from the build log's
    ``-Xptxas=-v`` lines."""
    found, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(\w+)'?", ln)
        if m:
            name = m.group(1) if marker in m.group(1) else None
            continue
        if name is None:
            continue
        entry = found.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            entry.update(spill_stores=int(m.group(1)),
                         spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            entry["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            entry["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return found


def wgmma_warnings(log: str) -> list:
    """ptxas' lines about wgmma it serialised (C7512/C7518, "wgmma ...
    serialized") or fenced: the warpgroup.arrive / warpgroup.wait it
    injects to let registers cross a GMMA (C7519/C7517), which do not say
    "wgmma"."""
    return [ln.strip() for ln in log.splitlines()
            if re.search(r"\(C75\d\d\)|warpgroup\.(arrive|wait)|GMMA", ln)
            or ("wgmma" in ln and ("warning" in ln.lower()
                                   or "Performance Loss" in ln))]


def phase_build() -> None:
    t0 = time.perf_counter()
    kernels.library()
    secs = time.perf_counter() - t0
    log = kernels.build_log()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    # B2/B3's warp-specialised kernel (its 384 threads at 168 registers,
    # which setmaxnreg moves to the consumers; 129 KB of dynamic shared
    # memory besides) and ptxas' word on any wgmma it had to serialise; B5's
    # forward and fused backward (dynamic shared memory besides: 48-132 and
    # 81-163 KB by head dim and bias, set at launch) and its dq rounding
    # kernel; B7's warp-specialised kernel (384 threads, setmaxnreg moving
    # registers from the producer to the consumers; 200-227 KiB of dynamic
    # shared memory by grid) and its mma.sync kernel for wide grids; B8's
    # instantiations by type and access width
    emit("build", seconds=round(secs, 3), ptxas=ptxas,
         attention_qkv_ptxas=ptxas_by_kernel(log, "attention_qkv_kernel"),
         wgmma_warnings=wgmma_warnings(log),
         attention_hm_fwd_ptxas=ptxas_by_kernel(log, "attention_hm_fwd"),
         attention_hm_bwd_ptxas=ptxas_by_kernel(log, "attention_hm_bwd"),
         attention_hm_dq_round_ptxas=ptxas_by_kernel(log, "dq_round"),
         attention_relpos_ptxas=ptxas_by_kernel(log, "attention_relpos"),
         deform_sample_ptxas=ptxas_by_kernel(log, "deform_sample"),
         layer_norm_ptxas=ptxas_by_kernel(log, "layer_norm"),
         swiglu_gate_ln_ptxas=ptxas_by_kernel(log, "swiglu_gate_ln"),
         rope_rotate_ptxas=ptxas_by_kernel(log, "rope_rotate"))


def _randn(gen: np.random.RandomState, dev):
    def randn(*shape):
        return torch.from_numpy(gen.standard_normal(shape).astype(
            np.float32)).to(dev)
    return randn


def check_layer_norm(randn, cases, phase: str) -> list:
    rows = []
    for shape, eps, dtype, *offset in cases:
        c = shape[-1]
        atol, rtol = LN_TOL[dtype]
        # x `offset` elements past the start of its buffer (the buffers
        # start 16-byte aligned)
        skip = offset[0] if offset else 0
        x = randn(int(np.prod(shape)) + skip).to(dtype)[skip:].view(shape)
        w = randn(c) * 0.1 + 1.0
        b = randn(c) * 0.1
        got = layer_norm_cuda(x, w, b, eps).float()
        want = layer_norm_plain(x.float(), w, b, eps)
        torch.cuda.synchronize()
        err = (got - want).abs()
        ok = bool((err <= atol + rtol * want.abs()).all())
        max_abs = float(err.max())
        wl, bl = w.to(dtype), b.to(dtype)
        row = dict(shape=list(shape), dtype=str(dtype), x_offset_bytes=(
                       x.data_ptr() % 16), max_abs_err=max_abs, ok=ok,
                   ms=time_ms(lambda: layer_norm_cuda(x, w, b, eps)),
                   plain_ms=time_ms(lambda: layer_norm_plain(x, w, b, eps)),
                   library_ms=time_ms(lambda: F.layer_norm(x, (c,), wl, bl,
                                                           eps)),
                   library_call="F.layer_norm (weights in x's dtype)",
                   **ln_bound(shape, dtype))
        emit(phase, atol=atol, rtol=rtol, **row)
        if not ok:
            raise AssertionError(f"layer_norm kernel disagrees at {shape}: "
                                 f"max abs err {max_abs}")
        rows.append(row)
    return rows


def check_swiglu_gate_ln(randn) -> list:
    """The gate-and-sub-LN kernel at ``SWIGLU_CASES`` against its plain twin
    (fp32 from the same g) within LN_TOL, pad columns exactly zero; events
    ms beside the twin's and the unpadded route's three library passes
    (``F.silu``, the multiply, ``F.layer_norm`` on the [rows, H] halves)."""
    rows_out = []
    for rows, h, hp, dtype in SWIGLU_CASES:
        atol, rtol = LN_TOL[dtype]
        g = (randn(rows, 2 * hp) * 2).to(dtype)
        w = randn(h) * 0.1 + 1.0
        b = randn(h) * 0.1
        got = swiglu_gate_ln_cuda(g, h, w, b, 1e-6)
        want = swiglu_gate_ln_plain(g.float(), h, w, b, 1e-6)
        torch.cuda.synchronize()
        err = (got.float() - want).abs()
        ok = bool((err <= atol + rtol * want.abs()).all()
                  and not got[:, h:].any())
        a, bh = g[:, :h], g[:, hp:hp + h]
        wl, bl = w.to(dtype), b.to(dtype)
        row = dict(shape=[rows, 2 * hp], hidden=h, dtype=str(dtype),
                   max_abs_err=float(err.max()), ok=ok,
                   ms=time_ms(lambda: swiglu_gate_ln_cuda(g, h, w, b, 1e-6)),
                   plain_ms=time_ms(lambda: swiglu_gate_ln_plain(g, h, w, b,
                                                                 1e-6)),
                   library_ms=time_ms(lambda: F.layer_norm(
                       F.silu(a) * bh, (h,), wl, bl, 1e-6)),
                   library_call="F.layer_norm(F.silu(a) * b) on the halves",
                   **bound(3 * rows * hp * g.element_size() + 2 * h * 4,
                           20 * rows * h, "fp32"))
        emit("kernel_swiglu_gate_ln", atol=atol, rtol=rtol, **row)
        if not ok:
            raise AssertionError(f"swiglu_gate_ln kernel disagrees at "
                                 f"{row['shape']}: max abs err "
                                 f"{row['max_abs_err']}")
        rows_out.append(row)
    return rows_out


def _qkv_views(randn, b_, n, h, fused):
    e = h * 64
    if fused:
        qkv = randn(b_, n, 3 * e).to(torch.bfloat16)
        return qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
    return tuple(randn(b_, n, e).to(torch.bfloat16) for _ in range(3))


def _hm(t, h, d=64):
    """[B, N, H*d] -> a [B, H, N, d] view."""
    b_, n, _ = t.shape
    return t.reshape(b_, n, h, d).transpose(1, 2)


def _summary(name, source, replaces, row, err, **extra) -> dict:
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, **{k: row[k] for k in keys},
                shape=row["shape"], **extra)


def phase_kernels(dev) -> list:
    randn = _randn(np.random.RandomState(SEED), dev)
    ln_rows = check_layer_norm(randn, LN_CASES, "kernel_layer_norm")

    attn_rows = []
    for b_, n, h, fused in ATTN_SHAPES:
        e = h * 64
        scale = 64 ** -0.5
        q, k, v = _qkv_views(randn, b_, n, h, fused)

        def heads(t):
            return t.reshape(b_, n, h, 64)

        got = attention_qkv_tm(q, k, v, h, scale).float()
        want = attention_plain(heads(q.float()), heads(k.float()),
                               heads(v.float()), scale=scale).reshape(b_, n, e)
        torch.cuda.synchronize()
        max_abs = float((got - want).abs().max())
        ok = max_abs <= ATTN_ATOL
        hq, hk, hv = (_hm(t, h) for t in (q, k, v))
        row = dict(
            shape=[b_, n, h, 64], fused_qkv=fused, max_abs_err=max_abs, ok=ok,
            ms=time_ms(lambda: attention_qkv_tm(q, k, v, h, scale)),
            device_ms=profiled_ms(lambda: attention_qkv_tm(
                q, k, v, h, scale))["device_ms"],
            plain_ms=time_ms(lambda: attention_plain(
                heads(q), heads(k), heads(v), scale=scale)),
            library_ms=time_ms(lambda: sdpa_fwd(hq, hk, hv, scale)),
            library_device_ms=profiled_ms(lambda: sdpa_fwd(
                hq, hk, hv, scale))["device_ms"],
            **attn_bound(b_, h, n, n, 2, (n, n, n), (n,), 0))
        emit("kernel_attention_qkv", atol=ATTN_ATOL, **row)
        if not ok:
            raise AssertionError(f"attention kernel disagrees at "
                                 f"{(b_, n, h)}: max abs err {max_abs}")
        attn_rows.append(row)
        del q, k, v, got, want, hq, hk, hv
        torch.cuda.empty_cache()

    # the per-kernel summary times the largest shape on the path (the
    # refine batch); every shape's numbers are on the lines above
    return [
        _summary("layer_norm", "vfmseg_tpu_torch/csrc/layer_norm.cu",
                 "vfmseg_tpu/ops/norm.py:28", ln_rows[1],
                 max(r["max_abs_err"] for r in ln_rows)),
        _summary("attention_qkv", "vfmseg_tpu_torch/csrc/attention_qkv.cu",
                 "vfmseg_tpu/ops/flash_attention.py:873", attn_rows[1],
                 max(r["max_abs_err"] for r in attn_rows),
                 device_ms=attn_rows[1]["device_ms"],
                 library_device_ms=attn_rows[1]["library_device_ms"]),
    ]


def _grad_errors(grads, refs, shape):
    return {name: float((got.float() - r.grad.reshape(shape)).abs().max()
                        / r.grad.abs().max())
            for name, got, r in zip(("dq", "dk", "dv"), grads, refs)}


def phase_kernels_train(dev) -> list:
    randn = _randn(np.random.RandomState(SEED + 3), dev)
    rows = []
    for b_, n, h, fused in TRAIN_ATTN_SHAPES:
        e = h * 64
        scale = 64 ** -0.5
        q, k, v = _qkv_views(randn, b_, n, h, fused)
        if fused:
            dqkv = torch.empty((b_, n, 3 * e), dtype=torch.bfloat16,
                               device=dev)
            dq, dk, dv = dqkv[..., :e], dqkv[..., e:2 * e], dqkv[..., 2 * e:]
        else:
            dq, dk, dv = torch.empty((3, b_, n, e), dtype=torch.bfloat16,
                                     device=dev)
        dout = randn(b_, n, e).to(torch.bfloat16)

        def heads(t):
            return t.reshape(b_, n, h, 64)

        out, lse = attention_fwd_lse_tm(q, k, v, h, scale)
        before = kernels.ATTENTION_HM_BWD.launches
        attention_bwd_tm(q, k, v, out, lse, dout, h, scale, dq, dk, dv)
        bwd_launches = kernels.ATTENTION_HM_BWD.launches - before

        ref = [heads(t.float()).requires_grad_(True) for t in (q, k, v)]
        want_out, want_lse = attention_fwd_lse_plain(*ref, scale=scale)
        want_out.backward(heads(dout.float()))
        torch.cuda.synchronize()
        want_out, want_lse = want_out.detach(), want_lse.detach()
        out_err = float((out.float() - want_out.reshape(b_, n, e)).abs().max())
        lse_err = float((lse - want_lse).abs().max())
        grad_err = _grad_errors((dq, dk, dv), ref, (b_, n, e))
        ok = (out_err <= ATTN_ATOL and lse_err <= LSE_ATOL
              and max(grad_err.values()) <= GRAD_REL and bwd_launches == 1)
        plain_in = [heads(t) for t in (q, k, v)]
        p_out, p_lse = attention_fwd_lse_plain(*plain_in, scale=scale)
        hq, hk, hv, hdo = (_hm(t, h) for t in (q, k, v, dout))
        # the library yardstick: the faster of the single calls that return
        # the LSE too, among those whose LSE agrees with ours
        lib_calls = lse_library_calls(hq, hk, hv, scale)
        libraries = {name: lse_agreement(call, lse)
                     for name, call in lib_calls.items()}
        for name, lib in libraries.items():
            lib.update(ms=time_ms(lib_calls[name]),
                       device_ms=profiled_ms(lib_calls[name])["device_ms"])
        same = [name for name, lib in libraries.items()
                if lib["same_function"]]
        if not same:
            raise AssertionError(f"no library call computes B3's function "
                                 f"at {(b_, n, h)}: {libraries}")
        lib_name = min(same, key=lambda name: libraries[name]["ms"])
        row = dict(
            shape=[b_, n, h, 64], fused_qkv=fused, out_max_abs_err=out_err,
            lse_max_abs_err=lse_err, grad_rel_err=grad_err,
            bwd_launches=bwd_launches, ok=ok,
            fwd_ms=time_ms(lambda: attention_fwd_lse_tm(q, k, v, h, scale)),
            fwd_device_ms=profiled_ms(lambda: attention_fwd_lse_tm(
                q, k, v, h, scale))["device_ms"],
            fwd_plain_ms=time_ms(lambda: attention_fwd_lse_plain(
                *plain_in, scale=scale)),
            fwd_library_ms=libraries[lib_name]["ms"],
            fwd_library_device_ms=libraries[lib_name]["device_ms"],
            fwd_library_call=lib_name, fwd_libraries=libraries,
            bwd_ms=time_ms(lambda: attention_bwd_tm(
                q, k, v, out, lse, dout, h, scale, dq, dk, dv)),
            bwd_plain_ms=time_ms(lambda: attention_bwd_plain(
                *plain_in, p_out, p_lse, heads(dout), scale=scale)),
            bwd_library_ms=time_ms(sdpa_bwd_fn(hq, hk, hv, hdo, scale)),
            fwd_bound=attn_bound(b_, h, n, n, 2, (n, n, n), (n,), 1),
            bwd_bound=attn_bound(b_, h, n, n, 5, (n, n, n, n), (n, n, n), 2))
        emit("kernel_attention_train", out_atol=ATTN_ATOL, lse_atol=LSE_ATOL,
             grad_rel=GRAD_REL, **row)
        if not ok:
            raise AssertionError(f"training attention kernels disagree at "
                                 f"{(b_, n, h)}: {row}")
        rows.append(row)
        del q, k, v, dq, dk, dv, dout, out, lse, ref, plain_in
        torch.cuda.empty_cache()

    # B4's function (B3's backward) runs on B5's fused backward: its numbers
    # ride on that kernel's summary row (``b4_function``), timed at the
    # path's shape through attention_bwd_tm (delta, the zeroed dq workspace,
    # the fused kernel and the dq rounding); errors are the worst over every
    # shape
    path = rows[0]
    b4 = dict(
        replaces=B4_REPLACES, shape=path["shape"],
        computed_by="attention_bwd_tm -> attention_hm_bwd over [B, H, N, 64] "
                    "views, csrc/attention_hm.cu",
        max_abs_err=max(r["grad_rel_err"][g] for r in rows
                        for g in ("dq", "dk", "dv")),
        err_kind="max abs err / max |ref|", ms=path["bwd_ms"],
        plain_ms=path["bwd_plain_ms"], library_ms=path["bwd_library_ms"],
        library_call="autograd through F.scaled_dot_product_attention",
        bound_ms=path["bwd_bound"]["bound_ms"],
        bound_by=path["bwd_bound"]["bound_by"])
    emit("kernel_b4_on_hm_bwd", grad_rel=GRAD_REL, **b4)
    return _train_summaries(rows, (
        ("attention_fwd_lse", "fwd", "vfmseg_tpu_torch/csrc/attention_qkv.cu",
         "vfmseg_tpu/ops/flash_attention.py:684"),)), b4


# B4's TPU kernels, whose function B5's fused backward computes
B4_REPLACES = ("vfmseg_tpu/ops/flash_attention.py:1397, "
               "vfmseg_tpu/ops/flash_attention.py:1444")
# B5's entries: (name, kind, source, TPU kernel), without and with a bias;
# the fused backward replaces both TPU backward kernels
B5_ENTRIES = (
    ("attention_hm_fwd", "fwd", "vfmseg_tpu_torch/csrc/attention_hm.cu",
     "vfmseg_tpu/ops/flash_attention.py:71"),
    ("attention_hm_bwd", "bwd", "vfmseg_tpu_torch/csrc/attention_hm.cu",
     "vfmseg_tpu/ops/flash_attention.py:278, "
     "vfmseg_tpu/ops/flash_attention.py:344"))
B5_BIAS_ENTRIES = tuple((name.replace("hm_", "hm_bias_"), *rest)
                        for name, *rest in B5_ENTRIES)
B5_D32_ENTRIES = tuple((f"{name}_d32", *rest) for name, *rest in B5_ENTRIES)


def _train_summaries(rows, entries) -> list:
    """Summary rows of a training attention's entries, ``(name, kind,
    source, replaces)`` with kind "fwd" or "bwd" (the row keys
    ``{kind}_ms`` and ``{kind}_bound``), timed at the first (the path's)
    shape; errors are the worst over every shape."""
    path = rows[0]
    out = []
    for name, kind, source, replaces in entries:
        b = path[f"{kind}_bound"]
        row = dict(name=name, route="cuda", source=source, replaces=replaces,
                   ms=path[f"{kind}_ms"], bound_ms=b["bound_ms"],
                   bound_by=b["bound_by"], shape=path["shape"])
        if kind == "fwd":
            row.update(
                max_abs_err=max(r["out_max_abs_err"] for r in rows),
                lse_max_abs_err=max(r["lse_max_abs_err"] for r in rows),
                plain_ms=path["fwd_plain_ms"],
                library_ms=path["fwd_library_ms"],
                library_call=path.get(
                    "fwd_library_call",
                    "F.scaled_dot_product_attention (no LSE)"),
                **{k: path[f"fwd_{k}"] for k in ("device_ms",
                                                 "library_device_ms")
                   if f"fwd_{k}" in path})
        else:
            row.update(
                max_abs_err=max(max(r["grad_rel_err"].values())
                                for r in rows),
                err_kind="max abs err / max |ref|",
                plain_ms=path["bwd_plain_ms"],
                library_ms=path["bwd_library_ms"],
                plain_computes="dq, dk, dv", library_computes="dq, dk, dv",
                library_call="autograd through "
                             "F.scaled_dot_product_attention")
        out.append(row)
    return out


def _rope_tables(n, grid, dev):
    cos, sin = vit_rope_tables(grid[0], grid[1], 64, 1, 16, True)
    if cos.shape[0] != n:
        raise ValueError(f"a {grid} grid with a cls row has {cos.shape[0]} "
                         f"tokens, not {n}")
    return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(dev)
                 for t in permuted_rope_tables(cos, sin))


def check_rope_attention(randn, dev) -> list:
    rows = []
    for b_, n, h, grid, v_apart in ROPE_SHAPES:
        e = h * 64
        scale = 64 ** -0.5
        q, k, v = _qkv_views(randn, b_, n, h, True)
        if v_apart:
            v = randn(b_, n, e).to(torch.bfloat16)
        cos, sin = _rope_tables(n, grid, dev)

        def heads(t):
            return t.reshape(b_, n, h, 64)

        rot = torch.empty((b_, n, 2 * e), dtype=torch.bfloat16, device=dev)
        got = attention_qkv_rope_tm(q, k, v, cos, sin, h, scale,
                                    rot=rot).float()
        # the twin's rotation (fp32, rounded to bf16), then fp32 attention
        c, s = cos[None, :, None, :], sin[None, :, None, :]
        qr, kr = (apply_rope_permuted(heads(t).float(), c, s)
                  .to(torch.bfloat16) for t in (q, k))
        want = attention_plain(qr.float(), kr.float(), heads(v).float(),
                               scale=scale).reshape(b_, n, e)
        torch.cuda.synchronize()
        max_abs = float((got - want).abs().max())
        # the rotation pass alone: the workspace against the twin's rotation,
        # bit for bit (both round each fp32 product before the sum, then
        # round once to bf16)
        rot_differ = int((rot != torch.cat([qr.reshape(b_, n, e),
                                            kr.reshape(b_, n, e)], -1)).sum())
        ok = max_abs <= ATTN_ATOL and rot_differ == 0
        hq, hk, hv = (_hm(t, h) for t in (q, k, v))
        # bytes: q, k, v, out and the two fp32 [N, 64] tables; the rotation
        # adds 3 operations per q/k element, negligible beside the products
        b = attn_bound(b_, h, n, n, 2, (n, n, n), (n,), 0)
        b = bound(b["bytes"] + 2 * n * 64 * 4, b["ops"], "bf16_tensor")
        # the rotation pass: q and k read and written once, the tables read
        # once; 3 fp32 operations a rotated element
        rot_bound = bound(2 * 2 * b_ * n * e * 2 + 2 * n * 64 * 4,
                          3.0 * 2 * b_ * n * e, "fp32")
        prof = profiled_ms(lambda: attention_qkv_rope_tm(q, k, v, cos, sin,
                                                         h, scale))
        by_kernel = prof["device_ms_by_kernel"]
        rot_ms = sum(ms for name, ms in by_kernel.items()
                     if "rope_rotate" in name)
        row = dict(
            shape=[b_, n, h, 64], grid=list(grid), v_apart=v_apart,
            max_abs_err=max_abs, rotate_elements_differing=rot_differ,
            rotate_elements=rot.numel(), ok=ok,
            ms=time_ms(lambda: attention_qkv_rope_tm(q, k, v, cos, sin, h,
                                                     scale)),
            device_ms=prof["device_ms"], device_ms_by_kernel=by_kernel,
            rotate_device_ms=rot_ms, rotate_bound_ms=rot_bound["bound_ms"],
            rotate_bound_by=rot_bound["bound_by"],
            plain_ms=time_ms(lambda: attention_qkv_rope_plain(
                heads(q), heads(k), heads(v), cos, sin, scale=scale)),
            library_ms=time_ms(lambda: sdpa_fwd(hq, hk, hv, scale)),
            library_device_ms=profiled_ms(lambda: sdpa_fwd(
                hq, hk, hv, scale))["device_ms"],
            library_computes="attention without the rotation", **b)
        emit("kernel_attention_qkv_rope", atol=ATTN_ATOL, **row)
        if not ok:
            raise AssertionError(f"RoPE attention kernel disagrees at "
                                 f"{(b_, n, h)}: max abs err {max_abs}, "
                                 f"{rot_differ} rotated elements differ")
        rows.append(row)
        del q, k, v, got, want, hq, hk, hv, rot, qr, kr
        torch.cuda.empty_cache()
    return rows


def check_headmajor(randn, dev, shapes=HM_SHAPES,
                    phase: str = "kernel_attention_headmajor",
                    kv_fused: bool = False, d: int = 64) -> list:
    """B5's forward (with the LSE; at D 32 also without it) and fused
    backward at ``shapes`` and head dim ``d`` against the fp32 plain
    versions; with ``kv_fused`` k and v are the two halves of one
    token-major kv tensor (MiT's ``kv`` projection)."""
    rows = []
    fwd_entry = (kernels.ATTENTION_HM_FWD_D32 if d == 32
                 else kernels.ATTENTION_HM_FWD)
    for b_, h, nq, nk in shapes:
        scale = d ** -0.5
        e = h * d
        # token-major [B, N, H*d] tensors, as the projections give them,
        # seen as [B, H, N, d] views
        q = _hm(randn(b_, nq, e).to(torch.bfloat16), h, d)
        if kv_fused:
            kv = randn(b_, nk, 2 * e).to(torch.bfloat16)
            k, v = _hm(kv[..., :e], h, d), _hm(kv[..., e:], h, d)
        else:
            k, v = (_hm(randn(b_, nk, e).to(torch.bfloat16), h, d)
                    for _ in range(2))
        dout = _hm(randn(b_, nq, e).to(torch.bfloat16), h, d)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))

        out, lse = attention_hm_fwd(q, k, v, scale)
        delta = (dout.float() * out.float()).sum(-1).contiguous()
        attention_hm_bwd(q, k, v, dout, lse, delta, scale, dq, dk, dv)

        ref = [t.float().transpose(1, 2).contiguous().requires_grad_(True)
               for t in (q, k, v)]
        want_out, want_lse = attention_fwd_lse_plain(*ref, scale=scale)
        want_out.backward(dout.float().transpose(1, 2))
        want_out = want_out.detach()
        routed_err = routed_launches = None
        if nq != nk or d != 64:
            # the dispatcher's route for Nq != Nk, or a head dim other than
            # 64, on the card: B5
            before = fwd_entry.launches
            routed = multi_head_attention(
                *(t.transpose(1, 2) for t in (q, k, v)), scale=scale)
            routed_launches = fwd_entry.launches - before
            routed_err = float((routed.float() - want_out).abs().max())
        nolse_err = None
        if d == 32:
            nolse = attention_hm_fwd(q, k, v, scale, with_lse=False)[0]
            nolse_err = float((nolse.float().transpose(1, 2)
                               - want_out).abs().max())
        torch.cuda.synchronize()
        out_err = float((out.float().transpose(1, 2) - want_out).abs().max())
        lse_err = float((lse - want_lse.detach()).abs().max())
        grad_err = _grad_errors(
            (t.transpose(1, 2) for t in (dq, dk, dv)), ref,
            (b_, -1, h, d))
        ok = (out_err <= ATTN_ATOL and lse_err <= LSE_ATOL
              and max(grad_err.values()) <= GRAD_REL
              and (nolse_err is None or nolse_err <= ATTN_ATOL)
              and (routed_err is None or (routed_err <= ATTN_ATOL
                                          and routed_launches == 1)))
        plain_in = [t.transpose(1, 2) for t in (q, k, v)]
        p_out, p_lse = attention_fwd_lse_plain(*plain_in, scale=scale)
        n_ = (nq, nk, nk)
        row = dict(
            shape=[b_, h, nq, nk, d], out_max_abs_err=out_err,
            lse_max_abs_err=lse_err, nolse_max_abs_err=nolse_err,
            grad_rel_err=grad_err,
            routed_max_abs_err=routed_err, routed_b5_launches=routed_launches,
            ok=ok,
            fwd_ms=time_ms(lambda: attention_hm_fwd(q, k, v, scale)),
            fwd_graph_ms=graph_ms(lambda: attention_hm_fwd(q, k, v, scale),
                                  dev),
            fwd_plain_ms=time_ms(lambda: attention_fwd_lse_plain(
                *plain_in, scale=scale)),
            fwd_library_ms=time_ms(lambda: sdpa_fwd(q, k, v, scale)),
            fwd_library_graph_ms=graph_ms(lambda: sdpa_fwd(q, k, v, scale),
                                          dev),
            bwd_ms=time_ms(lambda: attention_hm_bwd(
                q, k, v, dout, lse, delta, scale, dq, dk, dv)),
            bwd_graph_ms=graph_ms(lambda: attention_hm_bwd(
                q, k, v, dout, lse, delta, scale, dq, dk, dv), dev),
            # SDPA's backward alone: its forward and backward replayed as
            # one graph, less the forward's replay
            bwd_library_graph_ms=graph_ms(sdpa_fwd_bwd_fn(
                q, k, v, dout, scale), dev) - graph_ms(
                lambda: sdpa_fwd(q, k, v, scale), dev),
            bwd_plain_ms=time_ms(lambda: attention_bwd_plain(
                *plain_in, p_out, p_lse, dout.transpose(1, 2), scale=scale)),
            bwd_library_ms=time_ms(sdpa_bwd_fn(q, k, v, dout, scale)),
            fwd_bound=attn_bound(b_, h, nq, nk, 2, n_, (nq,), 1, d=d),
            bwd_bound=attn_bound(b_, h, nq, nk, 5, n_ + (nq,), n_, 2, d=d))
        if d == 32:
            row.update(
                fwd_nolse_ms=time_ms(lambda: attention_hm_fwd(
                    q, k, v, scale, with_lse=False)),
                fwd_nolse_bound=attn_bound(b_, h, nq, nk, 2, n_, (nq,), 0,
                                           d=d))
        emit(phase, out_atol=ATTN_ATOL, lse_atol=LSE_ATOL, grad_rel=GRAD_REL,
             kv_fused=kv_fused, **row)
        if not ok:
            raise AssertionError(f"head-major attention kernels disagree at "
                                 f"{(b_, h, nq, nk)}: {row}")
        rows.append(row)
        del q, k, v, dq, dk, dv, dout, out, lse, delta, ref, plain_in
        torch.cuda.empty_cache()
    return rows


def phase_kernels_eva02(dev) -> list:
    randn = _randn(np.random.RandomState(SEED + 11), dev)
    ln_rows = check_layer_norm(randn, LN_EVA02_CASES,
                               "kernel_layer_norm_eva02")
    ln_rows += check_layer_norm(randn, LN_OFF_PATH_CASES,
                                "kernel_layer_norm_off_path")
    rope_rows = check_rope_attention(randn, dev)
    swiglu_rows = check_swiglu_gate_ln(randn)
    hm_rows = check_headmajor(randn, dev)
    emit("kernels_eva02",
         layer_norm_2730_ms=[r["ms"] for r in ln_rows[:2]],
         swiglu_gate_ln_ms=[r["ms"] for r in swiglu_rows[:2]],
         rope_ms=[r["ms"] for r in rope_rows],
         headmajor_ms=[dict(fwd=r["fwd_ms"], bwd=r["bwd_ms"])
                       for r in hm_rows])
    return ln_rows, [
        _summary("attention_qkv_rope",
                 "vfmseg_tpu_torch/csrc/attention_qkv_rope.cu",
                 "vfmseg_tpu/ops/flash_attention.py:873", rope_rows[1],
                 max(r["max_abs_err"] for r in rope_rows),
                 device_ms=rope_rows[1]["device_ms"],
                 rotate_device_ms=rope_rows[1]["rotate_device_ms"],
                 rotate_bound_ms=rope_rows[1]["rotate_bound_ms"],
                 rotate_elements_differing=sum(
                     r["rotate_elements_differing"] for r in rope_rows),
                 library_device_ms=rope_rows[1]["library_device_ms"],
                 library_computes="attention without the rotation",
                 library_call="F.scaled_dot_product_attention"),
        _summary("swiglu_gate_ln", "vfmseg_tpu_torch/csrc/swiglu_gate_ln.cu",
                 "none: XLA's silu and multiply, then "
                 "vfmseg_tpu/ops/norm.py:45 (_ln_forward)", swiglu_rows[0],
                 max(r["max_abs_err"] for r in swiglu_rows),
                 library_call=swiglu_rows[0]["library_call"]),
    ] + _train_summaries(hm_rows, B5_ENTRIES)


def _relpos_inputs(randn, b_, h, grid, d):
    """q, k, v as head-major views of one fused [B, N, 3, H, d] bf16 tensor
    (the layout SAM's attention reads), and the rel terms that
    ``decomposed_rel_pos_terms_hm`` gives for q from tables as a block
    holds them (a window's 27 rows, or a global block's 127 rows resized to
    the grid), with the tables for the bias."""
    n = grid[0] * grid[1]
    qkv = randn(b_, n, 3, h, d).to(torch.bfloat16)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    length = 27 if grid == (14, 14) else 127
    tables = (randn(length, d) * 0.05, randn(length, d) * 0.05)
    rel_h, rel_w = decomposed_rel_pos_terms_hm(q, *tables, grid)
    return q, k, v, rel_h.contiguous(), rel_w.contiguous(), tables


# B7 off SAM's paths, at the kernel's other branches: (path, B, H, grid, head
# dim). An odd kw (the lookup's wrapping pairs) in one 64-key step with the
# second consumer idle, at D 64 and 80; an even kw that does not divide the
# 128-key step (the lookup's 8-byte pairs) with a 16-key tail (N 400); D 64
# at the windows' 80-key tail; kw 32 (rel_w in registers) with a remainder
# of 96 keys, a whole masked step (N 224); kh + kw = 200, whose rel rows
# do not fit beside the pipeline (the mma.sync kernel); and two cases on
# contiguous [B, H, N, D] q, k, v instead of fused-qkv views: the tensor
# maps' other dim order (head stride above token stride), and one batch
# item and one head (the strides of size-1 dims replaced).
RELPOS_OFF_PATH = [("off_path_d64", 2, 3, (6, 9), 64),
                   ("off_path_odd_kw", 2, 3, (6, 9), 80),
                   ("off_path_tail16", 2, 3, (20, 20), 80),
                   ("off_path_d64_window", 4, 3, (14, 14), 64),
                   ("off_path_masked_step", 2, 3, (7, 32), 80),
                   ("off_path_wide_grid", 1, 2, (4, 196), 80),
                   ("off_path_contiguous", 2, 3, (14, 14), 80),
                   ("off_path_one_head_contiguous", 1, 1, (32, 32), 80)]


def check_relpos(randn) -> list:
    rows = []
    cases = [(*shape, 80) for shape in RELPOS_SHAPES] + RELPOS_OFF_PATH
    for label, b_, h, grid, d in cases:
        n = grid[0] * grid[1]
        scale = d ** -0.5
        q, k, v, rel_h, rel_w, tables = _relpos_inputs(randn, b_, h, grid, d)
        if label.endswith("_contiguous"):
            q, k, v = (t.contiguous() for t in (q, k, v))
        got = attention_relpos_hm(q, k, v, rel_h, rel_w, scale).float()
        want = attention_decomposed_plain(q.float(), k.float(), v.float(),
                                          rel_h, rel_w, scale=scale)
        torch.cuda.synchronize()
        max_abs = float((got - want).abs().max())
        ok = max_abs <= ATTN_ATOL
        # the library call's [B, H, N, N] bf16 bias, built outside its timing
        bias = decomposed_rel_pos_bias_hm(q, *tables, grid)
        rel_bytes = b_ * h * n * (grid[0] + grid[1]) * 2
        row = dict(
            path=label, shape=[b_, h, n, d], grid=list(grid),
            max_abs_err=max_abs, ok=ok,
            ms=time_ms(lambda: attention_relpos_hm(q, k, v, rel_h, rel_w,
                                                   scale)),
            plain_ms=time_ms(lambda: attention_decomposed_plain(
                q, k, v, rel_h, rel_w, scale=scale)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias, scale=scale)),
            **attn_bound(b_, h, n, n, 2, (n, n, n), (n,), 0, d=d,
                         extra_bytes=rel_bytes))
        emit("kernel_attention_relpos", atol=ATTN_ATOL, **row)
        if not ok:
            raise AssertionError(f"rel-pos attention kernel disagrees at "
                                 f"{label} {(b_, h, n, d)}: max abs err "
                                 f"{max_abs}")
        rows.append(row)
        del q, k, v, rel_h, rel_w, bias, got, want
        torch.cuda.empty_cache()
    return rows


def time_b6_on_b5(randn) -> dict:
    """B6's function (head-major attention, no bias, no LSE) as the port
    computes it: B5's forward entry with the LSE off, over token-major
    [B, N, H*64] tensors seen as [B, H, N, 64] views."""
    b_, h, n = B6_SHAPE
    scale = 64 ** -0.5
    q, k, v = (_hm(randn(b_, n, h * 64).to(torch.bfloat16), h)
               for _ in range(3))
    got = attention_hm_fwd(q, k, v, scale, with_lse=False)[0].float()
    want = attention_plain(*(t.float().transpose(1, 2) for t in (q, k, v)),
                           scale=scale).transpose(1, 2)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    tok = [t.transpose(1, 2) for t in (q, k, v)]
    row = dict(
        shape=[b_, h, n, n, 64], max_abs_err=max_abs,
        ok=max_abs <= ATTN_ATOL,
        ms=time_ms(lambda: attention_hm_fwd(q, k, v, scale, with_lse=False)),
        plain_ms=time_ms(lambda: attention_plain(*tok, scale=scale)),
        library_ms=time_ms(lambda: sdpa_fwd(q, k, v, scale)),
        **attn_bound(b_, h, n, n, 2, (n, n, n), (n,), 0))
    emit("kernel_b6_on_b5_fwd", atol=ATTN_ATOL,
         replaces="vfmseg_tpu/ops/flash_attention.py:1684",
         computed_by="attention_hm_fwd(with_lse=False), csrc/attention_hm.cu",
         **row)
    if not row["ok"]:
        raise AssertionError(f"B5 forward without LSE disagrees at "
                             f"{B6_SHAPE}: max abs err {max_abs}")
    return row


def phase_kernels_sam(dev) -> list:
    randn = _randn(np.random.RandomState(SEED + 13), dev)
    rows = check_relpos(randn)
    b6 = time_b6_on_b5(randn)
    emit("kernels_sam", relpos_ms={r["path"]: r["ms"] for r in rows},
         relpos_bound_ms={r["path"]: r["bound_ms"] for r in rows},
         b6_on_b5_ms=b6["ms"])
    # the summary times the refine batch's global blocks; every shape's
    # numbers are in by_path
    summary = _summary("attention_relpos",
                       "vfmseg_tpu_torch/csrc/attention_relpos.cu",
                       "vfmseg_tpu/ops/flash_attention.py:1826", rows[3],
                       max(r["max_abs_err"] for r in rows),
                       library_call="F.scaled_dot_product_attention with "
                                    "the [B, H, N, N] bf16 bias")
    summary["by_path"] = {r["path"]: {k: r[k] for k in (
        "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
        for r in rows}
    return [summary]


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits as integers, for a bit-exact comparison."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _blend_inputs(gen, rs, dev, b, need, k, dtype) -> dict:
    """A finish step's blend at full size: ``need`` windows of the 18-box
    slide grid over ``b`` images, drawn without repeats and in ascending
    window id (image i % b, box i // b), then ``k - need`` zero pad rows at
    the last window's origin, as the engine builds them."""
    test_cfg = headline_config()["test_cfg"]
    crop = tuple(test_cfg["crop_size"])
    boxes = compute_slide_grid(IMAGE_HW, crop, tuple(test_cfg["stride"]))
    n = len(boxes) * b
    ids = sorted(rs.choice(n, need, replace=False).tolist()) + [n - 1] * (
        k - need)

    def idx(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    img_i = idx([i % b for i in ids])
    ys = idx([boxes[i // b][0] for i in ids])
    xs = idx([boxes[i // b][1] for i in ids])
    base = (torch.randn((b,) + IMAGE_HW + (19,), generator=gen, device=dev)
            * 4.0).to(dtype)
    delta = torch.randn((k,) + crop + (19,), generator=gen, device=dev) * 0.5
    delta[need:] = 0.0
    return dict(base=base, delta=delta.to(dtype), img_i=img_i, ys=ys, xs=xs,
                crop=crop)


def check_window_blend(dev) -> list:
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    rs = np.random.RandomState(SEED + 17)
    rows = []
    for label, b, need, k, dtype in BLEND_CASES:
        a = _blend_inputs(gen, rs, dev, b, need, k, dtype)
        base, delta, img_i, ys, xs = (a[n] for n in ("base", "delta", "img_i",
                                                     "ys", "xs"))
        ch, cw = a["crop"]
        got = blend_windows_cuda(base.clone(), delta, img_i, ys, xs)
        want = blend_windows_plain(base.clone(), delta, img_i, ys, xs)
        torch.cuda.synchronize()
        same = bool(torch.equal(_bits(got), _bits(want)))
        max_abs = float((got.float() - want.float()).abs().max())
        changed = int((got != base).any(-1).sum())
        # the library yardstick: one index_put_ with accumulate over the
        # windows' pixels (rows of C), its index built outside the timing
        h, w = IMAGE_HW
        pix = ((img_i.long()[:, None, None] * h + ys.long()[:, None, None]
                + torch.arange(ch, device=dev)[None, :, None]) * w
               + xs.long()[:, None, None]
               + torch.arange(cw, device=dev)[None, None, :]).reshape(-1)
        covered = int(torch.unique(pix).numel())
        rows_c = delta.reshape(-1, delta.shape[-1])
        work = base.clone()
        flat = work.view(-1, work.shape[-1])
        item = base.element_size()
        row = dict(
            path=label, shape=[b, h, w, 19], k=k, needed=need,
            pad_rows=k - need, dtype=str(dtype), bit_identical=same,
            max_abs_err=max_abs, pixels_changed=changed,
            covered_pixels=covered,
            ms=time_ms(lambda: blend_windows_cuda(work, delta, img_i, ys, xs)),
            plain_ms=time_ms(lambda: blend_windows_plain(work, delta, img_i,
                                                         ys, xs)),
            library_ms=time_ms(lambda: flat.index_put_((pix,), rows_c,
                                                       accumulate=True)),
            library_call="index_put_(accumulate=True) over the windows' "
                         "pixel rows",
            # the deltas read once, the covered base read and written once;
            # one add per delta element
            **bound(delta.numel() * item + 2 * covered * 19 * item,
                    delta.numel(), "fp32"))
        emit("kernel_window_blend", tolerance="bit-identical", **row)
        if not same:
            raise AssertionError(f"window blend kernel differs from the loop "
                                 f"at {label}: max abs err {max_abs}")
        rows.append(row)
        del a, base, delta, got, want, work, flat, pix, rows_c
        torch.cuda.empty_cache()
    return rows


def phase_kernels_compact(dev) -> list:
    rows = check_window_blend(dev)
    emit("kernels_compact", window_blend_ms={r["path"]: r["ms"] for r in rows},
         window_blend_bound_ms={r["path"]: r["bound_ms"] for r in rows})
    # the summary times a stream group at the calibrated skip; every shape's
    # numbers are in by_path
    summary = _summary("window_blend", "vfmseg_tpu_torch/csrc/window_blend.cu",
                       "vfmseg_tpu/ops/window_blend.py:51",
                       next(r for r in rows if r["path"] == "stream_skip"),
                       max(r["max_abs_err"] for r in rows),
                       tolerance="bit-identical",
                       library_call=rows[0]["library_call"])
    summary["by_path"] = {r["path"]: {key: r[key] for key in (
        "shape", "k", "dtype", "ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by")} for r in rows}
    return [summary]


def _bias_inputs(randn, b_, h, nq, nk, grid, d):
    """q, k, v and the bias of one B5-bias case: on a SAM path, views of
    one fused qkv tensor and the bf16 bias the block builds from its
    tables; off the path, token-major tensors and a bias broadcast over the
    heads."""
    if grid is not None:
        q, k, v, _, _, tables = _relpos_inputs(randn, b_, h, grid, d)
        return q, k, v, decomposed_rel_pos_bias_hm(q, *tables, grid)
    q = randn(b_, nq, h, d).to(torch.bfloat16).transpose(1, 2)
    k, v = (randn(b_, nk, h, d).to(torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    bias = (randn(b_, 1, nq, nk) * 0.5).to(torch.bfloat16)
    return q, k, v, bias.expand(b_, h, nq, nk)


def _bias_case(q, k, v, bias, dout, scale):
    """B5's two bias entries (forward with LSE, the fused backward with
    dbias) on one case, against autograd through the fp32 plain version;
    returns the kernels' tensors and the errors."""
    b_, h, nq, d = q.shape
    nk = k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dbias = torch.empty((b_, h, nq, nk), dtype=bias.dtype, device=q.device)
    out, lse = attention_hm_fwd(q, k, v, scale, bias=bias)
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    attention_hm_bwd(q, k, v, dout, lse, delta, scale, dq, dk, dv,
                     bias=bias, dbias=dbias)

    ref = [t.float().transpose(1, 2).contiguous().requires_grad_(True)
           for t in (q, k, v)]
    ref_bias = bias.float().requires_grad_(True)
    want_out, want_lse = attention_fwd_lse_plain(*ref, scale=scale,
                                                 bias=ref_bias)
    want_out.backward(dout.float().transpose(1, 2))
    torch.cuda.synchronize()
    out_err = float((out.float().transpose(1, 2)
                     - want_out.detach()).abs().max())
    lse_err = float((lse - want_lse.detach()).abs().max())
    grad_err = _grad_errors(
        (t.transpose(1, 2) for t in (dq, dk, dv)), ref, (b_, -1, h, d))
    grad_err["dbias"] = float((dbias.float() - ref_bias.grad).abs().max()
                              / ref_bias.grad.abs().max())
    ok = (out_err <= ATTN_ATOL and lse_err <= LSE_ATOL
          and max(grad_err.values()) <= GRAD_REL)
    kernel = dict(out=out, lse=lse, delta=delta, dq=dq, dk=dk, dv=dv,
                  dbias=dbias)
    return kernel, dict(out_max_abs_err=out_err, lse_max_abs_err=lse_err,
                        grad_rel_err=grad_err, ok=ok)


def check_headmajor_bias(randn, dev) -> list:
    """B5's two bias entries (forward with LSE, the fused backward with
    dbias) against autograd through the fp32 plain version with a random
    dO, at SAM's six path shapes with the bf16 bias its blocks build and a
    ragged head-broadcast case (timed beside their plain versions, SDPA and
    their bounds); then the six shapes again with an fp32 bias (kernel
    times only)."""
    rows = []
    cases = [(label, b_, h, g[0] * g[1], g[0] * g[1], g)
             for label, b_, h, g in RELPOS_SHAPES]
    cases.append(HM_BIAS_RAGGED + (None,))
    for label, b_, h, nq, nk, grid in cases:
        d = 80
        scale = d ** -0.5
        q, k, v, bias = _bias_inputs(randn, b_, h, nq, nk, grid, d)
        dout = randn(b_, h, nq, d).to(torch.bfloat16)
        kern, errs = _bias_case(q, k, v, bias, dout, scale)
        torch.cuda.empty_cache()
        lse, delta = kern["lse"], kern["delta"]
        dq, dk, dv, dbias = (kern[n] for n in ("dq", "dk", "dv", "dbias"))
        plain_in = [t.transpose(1, 2) for t in (q, k, v)]
        p_out, p_lse = attention_fwd_lse_plain(*plain_in, scale=scale,
                                               bias=bias)
        n_ = (nq, nk, nk)
        # the bias read once (its storage: a broadcast bias is smaller than
        # its view), and dbias written once in the bias's dtype
        bias_bytes = bias.untyped_storage().nbytes()
        dbias_bytes = dbias.numel() * dbias.element_size()
        row = dict(
            path=label, shape=[b_, h, nq, nk, d], bias_dtype=str(bias.dtype),
            bias_strides=list(bias.stride()), **errs,
            fwd_ms=time_ms(lambda: attention_hm_fwd(q, k, v, scale,
                                                    bias=bias)),
            fwd_plain_ms=time_ms(lambda: attention_fwd_lse_plain(
                *plain_in, scale=scale, bias=bias), reps=3, inner=2),
            fwd_library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias, scale=scale), reps=3, inner=3),
            bwd_ms=time_ms(lambda: attention_hm_bwd(
                q, k, v, dout, lse, delta, scale, dq, dk, dv, bias=bias,
                dbias=dbias)),
            bwd_plain_ms=time_ms(lambda: attention_bwd_plain(
                *plain_in, p_out, p_lse, dout.transpose(1, 2), scale=scale,
                bias=bias), reps=3, inner=2),
            bwd_library_ms=time_ms(sdpa_bias_bwd_fn(q, k, v, bias, dout,
                                                    scale), reps=3, inner=3),
            fwd_bound=attn_bound(b_, h, nq, nk, 2, n_, (nq,), 1, d=d,
                                 extra_bytes=bias_bytes),
            bwd_bound=attn_bound(b_, h, nq, nk, 5, n_ + (nq,), n_, 2, d=d,
                                 extra_bytes=bias_bytes + dbias_bytes))
        emit("kernel_attention_hm_bias", out_atol=ATTN_ATOL,
             lse_atol=LSE_ATOL, grad_rel=GRAD_REL, **row)
        if not row["ok"]:
            raise AssertionError(f"B5 bias kernels disagree at {label} "
                                 f"{(b_, h, nq, nk)}: {row}")
        rows.append(row)
        del q, k, v, bias, dout, kern, dq, dk, dv, dbias, lse, delta
        del plain_in, p_out, p_lse
        torch.cuda.empty_cache()

    for label, b_, h, grid in RELPOS_SHAPES:
        d = 80
        scale = d ** -0.5
        nq = grid[0] * grid[1]
        q, k, v, bias = _bias_inputs(randn, b_, h, nq, nq, grid, d)
        # fp32 values off bf16's grid
        bias = bias.float() + randn(*bias.shape) * 1e-2
        dout = randn(b_, h, nq, d).to(torch.bfloat16)
        kern, errs = _bias_case(q, k, v, bias, dout, scale)
        lse, delta = kern["lse"], kern["delta"]
        dq, dk, dv, dbias = (kern[n] for n in ("dq", "dk", "dv", "dbias"))
        n_ = (nq, nq, nq)
        row = dict(
            path=label, shape=[b_, h, nq, nq, d], bias_dtype=str(bias.dtype),
            **errs,
            fwd_ms=time_ms(lambda: attention_hm_fwd(q, k, v, scale,
                                                    bias=bias)),
            bwd_ms=time_ms(lambda: attention_hm_bwd(
                q, k, v, dout, lse, delta, scale, dq, dk, dv, bias=bias,
                dbias=dbias)),
            fwd_bound=attn_bound(b_, h, nq, nq, 2, n_, (nq,), 1, d=d,
                                 extra_bytes=bias.numel() * 4))
        emit("kernel_attention_hm_bias_fp32", out_atol=ATTN_ATOL,
             lse_atol=LSE_ATOL, grad_rel=GRAD_REL, **row)
        if not row["ok"]:
            raise AssertionError(f"B5 fp32-bias kernels disagree at {label} "
                                 f"{(b_, h, nq, nq)}: {row}")
        del q, k, v, bias, dout, kern, dq, dk, dv, dbias, lse, delta
        torch.cuda.empty_cache()
    return rows


def check_deform_sample(dev) -> list:
    """B8 against ``sample_plain`` in fp32 on the same inputs, at the eval
    shape in bf16 and fp32, at cases off the path and at the Rein model's
    six level shapes, with coordinates in [-0.1, 1.1]: taps and whole
    samples outside the plane read zero."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    rows = []
    cases = [("eval", DEFORM_SHAPE, torch.bfloat16),
             ("eval_fp32", DEFORM_SHAPE, torch.float32),
             ("off_path", DEFORM_OFF_PATH, torch.float32),
             ("off_path_bf16", DEFORM_OFF_PATH, torch.bfloat16),
             ("off_path_c64", DEFORM_WIDE, torch.bfloat16),
             ("off_path_misaligned", DEFORM_MISALIGNED, torch.bfloat16),
             ("off_path_misaligned_fp32", DEFORM_MISALIGNED, torch.float32)
             ] + [(label, shape, torch.bfloat16) for label, shape in
                  DEFORM_REIN]
    for label, (b_, h, w, c, n), dtype in cases:
        value = torch.randn((b_, h, w, c), generator=gen, device=dev).to(dtype)
        if label.startswith("off_path_misaligned"):
            # a contiguous view whose data starts 8 bytes into its storage
            skip = 8 // value.element_size()
            flat = torch.empty(value.numel() + skip, dtype=dtype, device=dev)
            flat[skip:] = value.reshape(-1)
            value = flat[skip:].view(b_, h, w, c)
        xn, yn = (torch.rand((b_, n), generator=gen, device=dev) * 1.2 - 0.1
                  for _ in range(2))
        got = sample_cuda(value, xn, yn).float()
        want = sample_plain(value.float(), xn, yn)
        torch.cuda.synchronize()
        atol, rtol = DEFORM_TOL[dtype]
        err = (got - want).abs()
        ok = bool((err <= atol + rtol * want.abs()).all())
        outside = ((xn < -0.5 / w) | (xn > 1 + 0.5 / w) | (yn < -0.5 / h)
                   | (yn > 1 + 0.5 / h))
        ok = ok and bool((got[outside] == 0).all())
        # the library call takes [B, C, H, W] and a grid in [-1, 1] of the
        # value's dtype (built outside its timing)
        vnchw = value.permute(0, 3, 1, 2)
        grid = torch.stack([xn * 2 - 1, yn * 2 - 1], -1)[:, None].to(dtype)
        item = value.element_size()
        row = dict(
            path=label, shape=[b_, h, w, c], samples=n, dtype=str(dtype),
            max_abs_err=float(err.max()), outside_share=float(
                outside.float().mean()), ok=ok,
            ms=time_ms(lambda: sample_cuda(value, xn, yn)),
            plain_ms=time_ms(lambda: sample_plain(value, xn, yn)),
            library_ms=time_ms(lambda: F.grid_sample(
                vnchw, grid, mode="bilinear", padding_mode="zeros",
                align_corners=False)),
            library_call="F.grid_sample(bilinear, zeros, "
                         "align_corners=False), grid in the value's dtype",
            # the value read once, both fp32 coordinates, the output written
            # once; ~7 fp32 operations a channel of a sample
            **bound(value.numel() * item + 2 * b_ * n * 4
                    + b_ * n * c * item, 7 * b_ * n * c, "fp32"))
        emit("kernel_deform_sample", atol=atol, rtol=rtol, **row)
        if not ok:
            raise AssertionError(f"B8 disagrees at {label}: {row}")
        rows.append(row)
        del value, xn, yn, got, want, err, vnchw, grid
        torch.cuda.empty_cache()
    return rows


def _deform_attn_inputs(dev, b_, nq, shapes, heads, d, points, dtype, seed,
                        skip):
    """Seeded arguments of ``ms_deform_attn_cuda``: the value (``skip``
    elements past its storage's start), offsets of a few pixels with every
    seventh query's forty times as far (whole samples off the planes),
    logits, and the reference points: the levels' pixel centres where the
    queries are the tokens, else random."""
    gen = torch.Generator().manual_seed(seed)
    lp = len(shapes) * points
    nv = sum(h * w for h, w in shapes)
    value = torch.randn(b_ * nv * heads * d + skip, generator=gen)
    value = value.to(dev, dtype)[skip:].view(b_, nv, heads * d)
    off = torch.randn(b_, nq, heads * lp * 2, generator=gen) * 3
    off[:, ::7] *= 40
    logits = torch.randn(b_, nq, heads * lp, generator=gen) * 2
    if nq == nv:
        ref_x, ref_y = _reference_points(shapes, dev)
    else:
        ref_x, ref_y = (torch.rand(nq, generator=gen).to(dev)
                        for _ in range(2))
    return value, off.to(dev, dtype), logits.to(dev, dtype), ref_x, ref_y


def check_deform_attn(dev) -> list:
    """The fused deformable core (``csrc/deform_attn.cu``) against
    ``ms_deform_attn_plain`` in fp32 on the same inputs at
    ``DEFORM_ATTN_CASES``, each call counted once under ``deform_attn``.
    Beside it the plain twin's time and the chain the eval route ran before
    it, from the same projections' outputs (``ms_deform_attn_levels``: B8 a
    level, the samples' copies, the batched gemv, the level sums)."""
    rows = []
    for seed, (label, b_, nq, shapes, heads, d, points, dtype,
               skip) in enumerate(DEFORM_ATTN_CASES):
        args = _deform_attn_inputs(dev, b_, nq, shapes, heads, d, points,
                                   dtype, SEED + 23 + seed, skip)
        value = args[0]
        before = kernels.DEFORM_ATTN.launches
        got = ms_deform_attn_cuda(*args, shapes, heads, points).float()
        launched = kernels.DEFORM_ATTN.launches - before
        want = ms_deform_attn_plain(*(t.float() for t in args), shapes,
                                    heads, points)
        torch.cuda.synchronize()
        atol, rtol = DEFORM_ATTN_TOL[dtype]
        err = (got - want).abs()
        ok = bool((err <= atol + rtol * want.abs()).all()) and launched == 1
        levels, start = [], 0
        for h, w in shapes:
            levels.append(value[:, start:start + h * w].reshape(b_, h, w, -1))
            start += h * w

        def chain():
            with torch.no_grad():
                return ms_deform_attn_levels(levels, *args[1:], heads,
                                             points)

        item = value.element_size()
        samples = b_ * nq * heads * len(shapes) * points
        row = dict(
            path=label, shape=dict(batch=b_, queries=nq,
                                   levels=[list(s) for s in shapes],
                                   heads=heads, head_dim=d, points=points),
            dtype=str(dtype), max_abs_err=float(err.max()), ok=ok,
            launches=launched,
            ms=time_ms(lambda: ms_deform_attn_cuda(*args, shapes, heads,
                                                   points)),
            plain_ms=time_ms(lambda: ms_deform_attn_plain(
                *args, shapes, heads, points)),
            chain_ms=time_ms(chain), library_ms=None,
            library_call="none: PyTorch has no deformable attention",
            # value, offsets, logits and reference points read once, the
            # output written once; ~9 fp32 operations a channel of a sample
            # (the taps' lerps and the weighted sum)
            **bound(sum(t.numel() * t.element_size() for t in args)
                    + b_ * nq * heads * d * item, 9 * samples * d, "fp32"))
        emit("kernel_deform_attn", atol=atol, rtol=rtol, **row)
        if not ok:
            raise AssertionError(f"the fused deformable core disagrees at "
                                 f"{label}: {row}")
        rows.append(row)
        del args, value, got, want, err, levels
        torch.cuda.empty_cache()
    return rows


def phase_kernels_bias_deform(dev) -> list:
    """B5's bias entries at SAM's bias route's shapes, B8 at Mask2Former's
    and the fused deformable core at Rein's slide; returns their summary
    rows."""
    randn = _randn(np.random.RandomState(SEED + 29), dev)
    bias_rows = check_headmajor_bias(randn, dev)
    deform_rows = check_deform_sample(dev)
    fused_rows = check_deform_attn(dev)
    emit("kernels_bias_deform",
         hm_bias_ms={r["path"]: dict(fwd=r["fwd_ms"], bwd=r["bwd_ms"])
                     for r in bias_rows},
         deform_sample_ms={r["path"]: r["ms"] for r in deform_rows},
         deform_attn_ms={r["path"]: r["ms"] for r in fused_rows})
    # the summaries time the train step's global blocks (B5-bias) and the
    # eval shape in bf16 (B8); every shape's numbers are in by_path
    train_global = next(r for r in bias_rows if r["path"] == "train_global")
    summary = _train_summaries(
        [train_global] + [r for r in bias_rows if r is not train_global],
        B5_BIAS_ENTRIES)
    for row, kind in zip(summary, ("fwd", "bwd")):
        row["library_call"] = ("F.scaled_dot_product_attention with the "
                               "float attn_mask" + (
                                   "" if kind == "fwd" else
                                   ", autograd for dq, dk, dv, dbias"))
        if kind != "fwd":
            row["plain_computes"] = row["library_computes"] = (
                "dq, dk, dv, dbias")
        row["by_path"] = {r["path"]: dict(
            shape=r["shape"], ms=r[f"{kind}_ms"],
            plain_ms=r["fwd_plain_ms" if kind == "fwd" else "bwd_plain_ms"],
            library_ms=r["fwd_library_ms" if kind == "fwd"
                         else "bwd_library_ms"],
            bound_ms=r[f"{kind}_bound"]["bound_ms"],
            bound_by=r[f"{kind}_bound"]["bound_by"]) for r in bias_rows}
    deform = _summary("deform_sample", "vfmseg_tpu_torch/csrc/deform_sample.cu",
                      "vfmseg_tpu/ops/deform_attn.py:134", deform_rows[0],
                      max(r["max_abs_err"] for r in deform_rows),
                      library_call=deform_rows[0]["library_call"])
    deform["by_path"] = {r["path"]: {key: r[key] for key in (
        "shape", "samples", "dtype", "ms", "plain_ms", "library_ms",
        "bound_ms", "bound_by")} for r in deform_rows}
    # the fused core's summary times one encoder layer at Rein's slide in
    # bf16, with the chain it replaced on the eval route
    fused = _summary("deform_attn", "vfmseg_tpu_torch/csrc/deform_attn.cu",
                     "vfmseg_tpu/ops/deform_attn.py:231 with the Pallas "
                     "sampler at :134", fused_rows[0],
                     max(r["max_abs_err"] for r in fused_rows),
                     library_call=fused_rows[0]["library_call"],
                     chain_ms=fused_rows[0]["chain_ms"])
    fused["by_path"] = {r["path"]: {key: r[key] for key in (
        "shape", "dtype", "ms", "plain_ms", "chain_ms", "bound_ms",
        "bound_by")} for r in fused_rows}
    return summary + [deform, fused]


def calibrate_logit_scale(model, engine, groups, target: float) -> tuple:
    """The decode head's logit scale at which the gate skips ~``target`` of
    the windows of ``groups`` (image batches), as bench.py:489-566 finds it:
    the rate of the scaled stage-1 map seeds a bracket, then a bisection on
    the skip rate the scaled model measures. The logits are linear in the
    classifier ``conv_seg``. Leaves the model at the returned scale."""
    seg = model.decode_head.conv_seg
    orig = [p.detach().clone() for p in (seg.weight, seg.bias)]
    hw = tuple(groups[0].shape[1:3])
    yx = engine._geometry(hw, groups[0].device)[0]

    def set_scale(s):
        with torch.no_grad():
            for p, o in zip((seg.weight, seg.bias), orig):
                p.copy_(o * s)

    @torch.inference_mode()
    def measured(s):
        set_scale(s)
        rates = [float((engine._stage1_impl(model, g, hw)[1]
                        >= engine.conf).float().mean()) for g in groups]
        return float(np.mean(rates))

    with torch.inference_mode():
        set_scale(1.0)
        full = engine._stage1_impl(model, groups[0], hw)[0].float()

        def analytic(s):
            conf = window_confidence(full * s, yx, engine.crop,
                                     engine.threshold)
            return float((conf >= engine.conf).float().mean())

        lo, hi = 1e-3, 1.0
        while analytic(hi) < target and hi < 1e12:
            lo, hi = hi, hi * 10.0
        seed, seed_r = hi, analytic(hi)
        for _ in range(25):
            mid = (lo * hi) ** 0.5
            r = analytic(mid)
            if abs(r - target) < abs(seed_r - target):
                seed, seed_r = mid, r
            lo, hi = (mid, hi) if r < target else (lo, mid)
        del full
    lo, hi = seed / 8.0, seed * 8.0
    while measured(hi) < target and hi < 1e12:
        lo, hi = hi, hi * 8.0
    while measured(lo) > target and lo > 1e-6:
        lo, hi = lo / 8.0, lo
    best, best_r = seed, measured(seed)
    evals = 0
    for _ in range(16):
        mid = (lo * hi) ** 0.5
        r = measured(mid)
        evals += 1
        if abs(r - target) < abs(best_r - target):
            best, best_r = mid, r
        if abs(r - target) <= 0.002:
            break
        lo, hi = (mid, hi) if r < target else (lo, mid)
    set_scale(best)
    return best, best_r, dict(analytic_seed=seed, analytic_rate=seed_r,
                              bisection_steps=evals)


def phase_compact_path(dev) -> dict:
    """The headline through the compact gated engine at full width: the
    gate calibrated to ~0.8 skip, the per-image compact predictor against
    the dense one, the stream at group 8, the eval CLI's dataset loop, and a
    profiler pass over the stream."""
    cfg = headline_config()
    t0 = time.perf_counter()
    model = init_params(build_segmentor(
        cfg["model"], dtype=compute_dtype(cfg),
        attn_impl=compute_attn_impl(cfg)), SEED)
    build_secs = time.perf_counter() - t0
    test_cfg = dict(cfg["test_cfg"], gate="compact")
    dense_cfg = cfg["test_cfg"]
    n_windows = len(compute_slide_grid(IMAGE_HW,
                                       tuple(test_cfg["crop_size"]),
                                       tuple(test_cfg["stride"])))
    imgs = synthetic_images(COMPACT_IMAGES, IMAGE_HW, SEED + 21).to(dev)
    groups = [imgs[i:i + COMPACT_GROUP]
              for i in range(0, COMPACT_IMAGES, COMPACT_GROUP)]
    engine = make_compact_ms_slide(model, test_cfg)
    t0 = time.perf_counter()
    scale, cal_rate, cal = calibrate_logit_scale(model, engine, groups,
                                                 TARGET_SKIP)
    cal_secs = time.perf_counter() - t0
    emit("compact_calibration", model=cfg["name"], logit_scale=scale,
         measured_skip=cal_rate, target_skip=TARGET_SKIP, seconds=cal_secs,
         images=COMPACT_IMAGES, **cal)

    # per image: the compact predictor, counted and timed, on every image
    predict = make_shape_aware_predict_fn(model, test_cfg)
    per_image = make_compact_ms_slide(model, test_cfg)
    # the dense gate's decisions per image, before the counted run
    refined = [refined_windows(model, imgs[i:i + 1], dense_cfg)
               for i in range(COMPACT_IMAGES)]
    want = {key: COMPACT_IMAGES * COMPACT_STAGE1[key]
            + sum(1 for n in refined if n) * COMPACT_FINISH[key]
            for key in COMPACT_STAGE1}
    latencies, preds = [], []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for i in range(COMPACT_IMAGES):
        img = imgs[i:i + 1]
        torch.cuda.synchronize()
        t = time.perf_counter()
        preds.append(predict(model, img, IMAGE_HW)[0])
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t)
    counts_image = kernels.launch_counts()
    if counts_image != want:
        raise AssertionError(f"compact per-image launch counts "
                             f"{counts_image} != {want}")

    # compact against dense, per image: refined counts, argmax, drift
    logits_fn = make_logits_fn(model, dense_cfg, dense_cfg["mode"])
    agree, drift, refined_compact = [], [], []
    for i in range(COMPACT_DENSE_IMAGES):
        img = imgs[i:i + 1]
        per_image.reset_stats()
        with torch.inference_mode():
            got, n = per_image(model, img)
            ref = logits_fn(model, img)
        refined_compact.append(n)
        got = got.float()
        agree.append(float((got.argmax(-1) == ref.argmax(-1)).float().mean()))
        # every third element: torch.quantile takes at most 2^24
        err = (got - ref).abs().flatten()[::3]
        mag = ref.abs().flatten()[::3]
        drift.append(float(torch.quantile(err, 0.99)
                           / torch.quantile(mag, 0.99).clamp(min=1e-9)))
        del got, ref, err, mag
    agreement = float(np.mean(agree))
    ok_dense = (refined_compact == refined[:COMPACT_DENSE_IMAGES]
                and agreement >= COMPACT_AGREE
                and max(drift) <= COMPACT_DRIFT_Q99
                and 0 < sum(refined) < n_windows * COMPACT_IMAGES)
    steady = latencies[1:]
    emit("compact_per_image", model=cfg["name"], images=COMPACT_IMAGES,
         image_hw=list(IMAGE_HW), model_build_s=build_secs,
         refined_windows=refined, windows_per_image=n_windows,
         skip=1 - sum(refined) / (n_windows * COMPACT_IMAGES),
         latency_s=latencies, images_per_s=len(steady) / sum(steady),
         launches=counts_image,
         vs_dense=dict(images=COMPACT_DENSE_IMAGES,
                       refined_compact=refined_compact,
                       refined_dense=refined[:COMPACT_DENSE_IMAGES],
                       argmax_agreement=agree, mean_agreement=agreement,
                       agreement_limit=COMPACT_AGREE, q99_rel_drift=drift,
                       drift_limit=COMPACT_DRIFT_Q99),
         ok=ok_dense)
    if not ok_dense:
        raise AssertionError(
            f"compact vs dense: refined {refined_compact} vs "
            f"{refined[:COMPACT_DENSE_IMAGES]}, agreement {agree}, drift "
            f"{drift}, refined in all {sum(refined)}")

    # the stream: warm up, then a timed run, counted; then a profiled one
    def run_stream():
        engine.reset_stats()
        out, marks = [], []
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        for i, pred in enumerate(stream_evaluate(
                model, test_cfg, [(im, IMAGE_HW) for im in imgs],
                group=COMPACT_GROUP, engine=engine)):
            out.append(pred)
            if i % COMPACT_GROUP == COMPACT_GROUP - 1:
                marks.append(time.perf_counter() - t_start)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t_start, marks

    run_stream()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    stream_preds, wall, marks = run_stream()
    counts_stream = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    n_groups = len(groups)
    group_need = [sum(refined[g * COMPACT_GROUP:(g + 1) * COMPACT_GROUP])
                  for g in range(n_groups)]
    want = {key: n_groups * COMPACT_STAGE1[key]
            + sum(1 for need in group_need if need) * COMPACT_FINISH[key]
            for key in COMPACT_STAGE1}
    stats = dict(windows=engine.stat_windows, refined=engine.stat_refined,
                 refine_rows=engine.stat_refine_rows,
                 padded=engine.stat_refine_rows - engine.stat_refined)
    stream_agree = [float((a == b).float().mean())
                    for a, b in zip(stream_preds, preds)]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        run_stream()
    ok_stream = (counts_stream == want and len(stream_preds) == COMPACT_IMAGES
                 and min(stream_agree) >= STREAM_AGREE)
    emit("compact_stream", model=cfg["name"], images=COMPACT_IMAGES,
         group=COMPACT_GROUP, depth=2, wall_s=wall,
         images_per_s=COMPACT_IMAGES / wall,
         group_done_s=marks, group_latency_s=np.diff([0.0] + marks).tolist(),
         measured_skip=1 - stats["refined"] / stats["windows"],
         gate=stats, buckets=[_bucket(need, engine.buckets)
                              for need in group_need],
         peak_mem_bytes=peak, launches=counts_stream, launches_reckoned=want,
         agreement_with_per_image=stream_agree, agreement_limit=STREAM_AGREE,
         ok=ok_stream, **_breakdown(prof, wall * 1e3))
    if not ok_stream:
        raise AssertionError(f"compact stream: launches {counts_stream} vs "
                             f"{want}, agreement {stream_agree}")

    phase_eval_cli(model, cfg, test_cfg, "compact_eval_cli")
    del model, engine, per_image, imgs, groups, preds, stream_preds
    torch.cuda.empty_cache()
    return {"compact_per_image": counts_image, "compact_stream": counts_stream}


def phase_eval_cli(model, cfg, test_cfg, phase: str) -> None:
    """The eval CLI's dataset loop (``evaluate_dataset``) over an in-memory
    labelled set of CLI_IMAGES 1024x2048 images; prints its metrics JSON."""
    rs = np.random.RandomState(SEED + 23)
    dataset = []
    for i in range(CLI_IMAGES):
        coarse = rs.randint(0, 256, (IMAGE_HW[0] // 32, IMAGE_HW[1] // 32, 3))
        img = np.repeat(np.repeat(coarse, 32, 0), 32, 1).astype(np.uint8)
        label = np.repeat(np.repeat(rs.randint(0, 19, coarse.shape[:2]), 32,
                                    0), 32, 1).astype(np.uint8)
        label[rs.rand(*IMAGE_HW) < 0.05] = 255
        dataset.append(dict(img=img, label=label, img_path=f"synth_{i}.png"))
    acc = IoUAccumulator(num_classes=cfg["num_classes"],
                         dataset_keys=["synth"])
    t0 = time.perf_counter()
    n_eval = evaluate_dataset(model, test_cfg, dataset,
                              TestPipeline(IMAGE_HW[::-1], True), acc,
                              "synth")
    results = acc.compute()
    cli_secs = time.perf_counter() - t0
    if n_eval != CLI_IMAGES or not np.isfinite(list(results.values())).all():
        raise AssertionError(f"eval loop: {n_eval} images, {results}")
    emit(phase, model=cfg["name"], images=n_eval, seconds=cli_secs,
         metrics=results)
    print(json.dumps(results), flush=True)


def _trainable_snapshot(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if p.requires_grad}


class MatchRecorder:
    """Records every call of the set loss's host matching
    (``m2f_loss._hungarian_host``, one a step): its host milliseconds, the
    cost matrices and the assignments."""

    def __enter__(self):
        self.ms, self.costs, self.assigned = [], [], []
        self._orig = m2f_loss._hungarian_host

        def timed(cost):
            t0 = time.perf_counter()
            out = self._orig(cost)
            self.ms.append((time.perf_counter() - t0) * 1e3)
            self.costs.append(np.asarray(cost))
            self.assigned.append(out)
            return out

        m2f_loss._hungarian_host = timed
        return self

    def __exit__(self, *exc):
        m2f_loss._hungarian_host = self._orig


def phase_train_path(dev, cfg, label: str, restore: bool,
                     steps: int = TRAIN_STEPS, phase: str = "",
                     stats_move: tuple = ()) -> tuple:
    """``steps`` train steps through ``InfiniteLoader`` and ``train_loop``
    (checkpoints every TRAIN_CKPT_EVERY and a fresh state restored from
    the last with ``restore``): launches per step, finite losses, every
    trainable parameter moved and every frozen one bit-equal, the
    BatchNorm statistics under each prefix of ``stats_move`` moved,
    steps/s and peak memory; with a set loss, the host matching's
    milliseconds."""
    shutil.rmtree(TRAIN_WORK_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    dtype = compute_dtype(cfg)
    impl = compute_attn_impl(cfg)
    model = init_params(build_segmentor(cfg["model"], dtype=dtype,
                                        attn_impl=impl), SEED)
    state = create_train_state(model, cfg)
    build_secs = time.perf_counter() - t0
    before = _trainable_snapshot(model)
    params = dict(model.named_parameters())
    frozen = {n: p.detach().clone() for n, p in params.items()
              if n not in before}
    n_train = sum(p.numel() for p in before.values())
    n_total = sum(p.numel() for p in model.parameters())
    stats_before = {n: b.clone() for n, b in model.named_buffers()
                    if n.endswith(("running_mean", "running_var"))}
    t0 = time.perf_counter()
    dataset = SyntheticDataset(n=4, hw=tuple(cfg["crop_size"]),
                               num_classes=cfg["num_classes"], seed=SEED)
    data_secs = time.perf_counter() - t0
    loader = InfiniteLoader(dataset, batch_size=cfg["data"]["batch_size"],
                            num_workers=2, seed=SEED)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with MatchRecorder() as matching:
            state = train_loop(state, make_train_step(), loader,
                               max_iters=steps, work_dir=TRAIN_WORK_DIR,
                               seed=SEED, log_interval=1,
                               checkpoint_interval=(TRAIN_CKPT_EVERY
                                                    if restore else 0),
                               max_keep_ckpts=2)
    finally:
        loader.close()
    torch.cuda.synchronize()
    loop_secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)

    want = {k: steps * v for k, v in PER_STEP[label].items()}
    if counts != want:
        raise AssertionError(f"{label} train launch counts {counts} != "
                             f"{want}")
    with open(os.path.join(TRAIN_WORK_DIR, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    if [r["step"] for r in records] != list(range(1, steps + 1)):
        raise AssertionError("train_loop did not log every step")
    losses = {k: [r[k] for r in records] for k in records[0]
              if "loss" in k or k in ("grad_norm",)}
    if not all(np.isfinite(v).all() for v in losses.values()):
        raise AssertionError(f"non-finite train metrics {losses}")
    after = _trainable_snapshot(model)
    # a parameter whose gradient is exactly zero (a bias right before a
    # GroupNorm, whose mean removes it) need not move; any other must
    unchanged = [n for n in before if torch.equal(before[n], after[n])
                 and (params[n].grad is None
                      or bool(params[n].grad.abs().max() > 0))]
    if unchanged:
        raise AssertionError(f"trainable parameters did not move: "
                             f"{unchanged[:5]}")
    buffers = dict(model.named_buffers())
    stats_moved = sorted(n for n, b in stats_before.items()
                         if not torch.equal(b, buffers[n]))
    still = [n for n in stats_before if n.startswith(stats_move)
             and n not in stats_moved] if stats_move else []
    if still or (stats_move and not stats_moved):
        raise AssertionError(f"BatchNorm statistics did not move: {still}")
    keywords = cfg["peft"].get("adapter_keywords", [])
    inner = unwrap_model(model)
    head = ("model." if inner is not model else "") + (
        "aux_head" if hasattr(inner, "aux_head") else "decode_head")
    if not all(any(k in n for n in before) for k in keywords) or not any(
            n.startswith(head) for n in before):
        raise AssertionError(f"{keywords} or {head} parameters are not "
                             f"trainable")
    moved = [n for n in frozen if not torch.equal(frozen[n], params[n])]
    if moved or any(p.grad is not None for n, p in params.items()
                    if n not in before):
        raise AssertionError(f"frozen parameters moved or got gradients: "
                             f"{moved}")

    ckpts = []
    if restore:
        # a fresh state from the same seed, restored from the last checkpoint
        fresh = create_train_state(init_params(
            build_segmentor(cfg["model"], dtype=dtype, attn_impl=impl), SEED),
            cfg)
        fresh = CheckpointManager(TRAIN_WORK_DIR).restore(fresh)
        got = dict(fresh.model.state_dict())
        mismatch = [n for n, t in model.state_dict().items()
                    if (n in before or "running" in n)
                    and not torch.equal(t, got[n])]
        opt_a = state.optimizer.state_dict()["state"]
        opt_b = fresh.optimizer.state_dict()["state"]
        opt_same = opt_a.keys() == opt_b.keys() and all(
            torch.equal(opt_a[i]["exp_avg"], opt_b[i]["exp_avg"])
            and torch.equal(opt_a[i]["exp_avg_sq"], opt_b[i]["exp_avg_sq"])
            for i in opt_a)
        if fresh.step != steps or mismatch or not opt_same:
            raise AssertionError(f"restore: step {fresh.step}, mismatched "
                                 f"{mismatch[:5]}, optimizer equal "
                                 f"{opt_same}")
        ckpts = sorted(os.listdir(os.path.join(TRAIN_WORK_DIR,
                                               "checkpoints")))
        del fresh, got
        torch.cuda.empty_cache()

    latency = [1.0 / r["steps_per_sec"] for r in records]
    steady = latency[1:]
    emit(phase or ("train_path" if label == "dinov2"
                   else f"{label}_train_path"),
         model=cfg["name"], steps=steps, batch=cfg["data"]["batch_size"],
         crop_hw=list(cfg["crop_size"]), model_build_s=build_secs,
         data_build_s=data_secs, loop_s=loop_secs,
         trainable_params=n_train, total_params=n_total,
         step_latency_s=latency, median_steady_step_s=float(
             np.median(steady)), steps_per_s=1.0 / float(np.median(steady)),
         peak_mem_bytes=peak, launches=counts,
         launches_per_step={k: v // steps for k, v in counts.items()},
         losses=losses, checkpoints=ckpts, frozen_params_equal=len(frozen),
         batch_norm_stats_moved=len(stats_moved),
         match_host_ms=matching.ms or None,
         restored_step=steps if restore else None)
    return state, counts


def _device_kernel_ms(prof) -> tuple:
    """Device time by kernel group, and the 12 largest kernels, from a
    profiler run (both empty when it recorded no device time)."""
    from torch.autograd import DeviceType

    groups, by_name = {}, {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue
        name = evt.key
        if name.startswith(("Optimizer.", "ProfilerStep")):
            continue  # annotation ranges on the device timeline, not kernels
        ms = getattr(evt, "self_device_time_total", 0.0) / 1e3
        for tag, marker in KERNEL_GROUPS:
            if marker in name:
                break
        else:
            tag = "gemm" if any(s in name.lower() for s in (
                "gemm", "nvjet", "cutlass", "xmma")) else "other"
        groups[tag] = groups.get(tag, 0.0) + ms
        by_name[name[:90]] = (by_name.get(name[:90], (0.0, 0))[0] + ms,
                              by_name.get(name[:90], (0.0, 0))[1]
                              + evt.count)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return groups, [dict(kernel=k, ms=v[0], calls=v[1]) for k, v in top]


def _breakdown(prof, step_ms: float) -> dict:
    """The profile's device time by kernel group, the attention kernels'
    share of it, and the idle share against an unprofiled ``step_ms``."""
    groups, top = _device_kernel_ms(prof)
    if not groups:
        return dict(kernel_ms="not measured (no device time in the profile)",
                    top_kernels=top, device_ms=None, kernel_share=None,
                    attention_share=None, idle_share=None)
    device_ms = sum(groups.values())
    attn = sum(v for k, v in groups.items() if k.startswith("attention"))
    return dict(kernel_ms=groups, top_kernels=top, device_ms=device_ms,
                kernel_share={k: v / device_ms for k, v in groups.items()},
                attention_share=attn / device_ms,
                idle_share=max(1 - device_ms / step_ms, 0.0))


def phase_train_breakdown(dev, cfg, state, label: str) -> None:
    """Forward / backward / optimizer of one more step (CUDA events, median
    of 3 steps), and the kernels' device time over one profiled step."""
    model, opt = state.model, state.optimizer
    ds = SyntheticDataset(n=2, hw=tuple(cfg["crop_size"]),
                          num_classes=cfg["num_classes"], seed=SEED + 5)
    batch = collate([ds[0], ds[1]])
    img = torch.from_numpy(batch["img"]).to(dev)
    label_t = torch.from_numpy(batch["label"]).to(dev)
    model.train()

    def one_step(events=None):
        opt.zero_grad(set_to_none=True)
        with rng.streams(step_generators(SEED, state.step, dev)):
            if events:
                events[0].record()
            loss = sum_losses(model(img, label_t))
            if events:
                events[1].record()
            loss.backward()
            if events:
                events[2].record()
            opt.step()
            if events:
                events[3].record()

    parts = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        one_step(ev)
        torch.cuda.synchronize()
        parts.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    fwd, bwd, optim = (float(np.median([p[i] for p in parts]))
                       for i in range(3))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        one_step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    step_ms = fwd + bwd + optim
    # idle against the unprofiled, event-timed step (the profiled wall time
    # carries the profiler's own overhead)
    emit("train_breakdown" if label == "dinov2"
         else f"{label}_train_breakdown", model=cfg["name"],
         forward_ms=fwd, backward_ms=bwd,
         optimizer_ms=optim, step_ms=step_ms, profiled_wall_ms=wall_ms,
         **_breakdown(prof, step_ms))


def phase_set_loss_split(dev, cfg, state, label: str) -> None:
    """Where a Mask2Former train step's time goes: CUDA events around the
    backbone's forward, the head's 10-stage forward, the set loss's
    forward (the matching's host sync and scipy included), then the
    backward in three parts by ``torch.autograd.grad``: the loss to the
    head's predictions, the head to its parameters and the backbone's maps
    and queries, the backbone to its trainable parameters (the reins).
    The median of 3 steps, with the host clock beside each."""
    model = state.model
    ds = SyntheticDataset(n=2, hw=tuple(cfg["crop_size"]),
                          num_classes=cfg["num_classes"], seed=SEED + 5)
    batch = collate([ds[0], ds[1]])
    img = torch.from_numpy(batch["img"]).to(dev)
    labels = torch.from_numpy(batch["label"]).to(dev)
    head_params = [p for p in model.decode_head.parameters()
                   if p.requires_grad]
    bb_params = [p for p in model.backbone.parameters() if p.requires_grad]
    names = ("backbone_fwd", "head_fwd", "loss_fwd", "loss_bwd", "head_bwd",
             "backbone_bwd")
    model.train()
    runs = []
    for i in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        host = [time.perf_counter()]

        def mark(j):
            ev[j].record()
            host.append(time.perf_counter())

        with rng.streams(step_generators(SEED, i, dev)):
            ev[0].record()
            feats, queries = model.features(img)
            mark(1)
            cls, masks = model.decode_head(feats, queries, train=True)
            mark(2)
            loss = sum_losses(m2f_loss.mask2former_loss(
                cls, masks, labels, num_classes=model.num_classes,
                num_points=model.num_points))
            mark(3)
            preds = list(cls) + list(masks)
            g_preds = torch.autograd.grad(loss, preds, retain_graph=True)
            mark(4)
            maps = list(feats) + [queries]
            g = torch.autograd.grad(preds, maps + head_params, g_preds)
            mark(5)
            torch.autograd.grad(maps, bb_params, g[:len(maps)])
            mark(6)
        torch.cuda.synchronize()
        runs.append(([ev[j].elapsed_time(ev[j + 1]) for j in range(6)],
                     [(host[j + 1] - host[j]) * 1e3 for j in range(6)]))
    device = {n: float(np.median([r[0][j] for r in runs]))
              for j, n in enumerate(names)}
    host_ms = {n: float(np.median([r[1][j] for r in runs]))
               for j, n in enumerate(names)}
    emit(f"{label}_train_split", model=cfg["name"], events_ms=device,
         host_ms=host_ms, step_events_ms=sum(device.values()),
         loss_share=(device["loss_fwd"] + device["loss_bwd"])
         / sum(device.values()))


def _train_check_config(cfg) -> dict:
    c = copy.deepcopy(cfg)
    m = c["model"]
    if m["type"] == "DomainGeneral":
        m = m["model_cfg"]
    m["hr_crop_size"] = TRAIN_CHECK_CROP
    m["backbone"]["Lora_config"]["lora_dropout"] = 0.0
    if "drop_path_rate" in m["backbone"]["backbone"]:
        m["backbone"]["backbone"]["drop_path_rate"] = 0.0
    m["decode_head"]["dropout_ratio"] = 0.0
    m["aux_head"]["dropout_ratio"] = 0.0
    m["aux_head"]["transformer"].update(dropout=0.0, mask_ratio=0.0)
    return c


def phase_train_card_vs_cpu(dev, cfg, label: str, check_cfg=None) -> None:
    c = _train_check_config(cfg) if check_cfg is None else check_cfg
    ds = SyntheticDataset(n=2, hw=TRAIN_CHECK_HW,
                          num_classes=c["num_classes"], seed=SEED + 7)
    batch = collate([ds[0], ds[1]])

    def one_step(device, dtype):
        model = init_params(build_segmentor(
            c["model"], dtype=dtype, device=device,
            attn_impl=compute_attn_impl(c)), SEED)
        state = create_train_state(model, c)
        t0 = time.perf_counter()
        _, metrics = make_train_step()(state, batch, SEED)
        metrics = {k: float(v) for k, v in metrics.items()}
        secs = time.perf_counter() - t0
        grad = torch.cat([p.grad.float().flatten().cpu()
                          for n, p in state.model.named_parameters()
                          if "lora" in n])
        return metrics, grad, secs

    card, card_g, card_s = one_step(dev, compute_dtype(cfg))
    cpu, cpu_g, cpu_s = one_step(torch.device("cpu"), torch.float32)
    rel = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-9)
           for k in cpu if "loss" in k}
    cos = float(F.cosine_similarity(card_g.double(), cpu_g.double(), dim=0))
    norm_rel = {
        "lora": abs(float(card_g.norm()) / float(cpu_g.norm()) - 1),
        "grad_norm": abs(card["grad_norm"] / cpu["grad_norm"] - 1)}
    ok = (all(np.isfinite(list(card.values())))
          and max(rel.values()) <= TRAIN_LOSS_REL and cos >= TRAIN_GRAD_COS
          and max(norm_rel.values()) <= TRAIN_GRAD_NORM_REL)
    emit("train_card_vs_cpu" if label == "dinov2"
         else f"{label}_train_card_vs_cpu", model=cfg["name"],
         image_hw=list(TRAIN_CHECK_HW),
         hr_crop=list(TRAIN_CHECK_CROP), card=card, cpu=cpu,
         loss_rel_err=rel, loss_rel_limit=TRAIN_LOSS_REL,
         lora_grad_cosine=cos, cosine_limit=TRAIN_GRAD_COS,
         grad_norm_rel_err=norm_rel, grad_norm_rel_limit=TRAIN_GRAD_NORM_REL,
         lora_grad_norm_card=float(card_g.norm()),
         lora_grad_norm_cpu=float(cpu_g.norm()), card_step_s=card_s,
         cpu_step_s=cpu_s, ok=ok)
    if not ok:
        raise AssertionError(f"{label} train card vs CPU: loss rel {rel}, "
                             f"LoRA gradient cosine {cos}, norms {norm_rel}")


def _assignment_checks(card: MatchRecorder, cpu: MatchRecorder,
                       exists: np.ndarray) -> dict:
    """The card's and the CPU's matchings of one step, over the classes
    present: the share of (stage, image) matchings that are equal, of
    stages equal for both images and of (stage, image, class) slots given
    the same query, and each card matching's excess cost under the CPU's
    fp32 costs over the CPU's own optimum, relative to that optimum's
    magnitude."""
    (cost,), (a_card,), (a_cpu,) = cpu.costs, card.assigned, cpu.assigned
    b = exists.shape[0]
    rows_equal, slots_equal, excess = [], [], []
    for i in range(cost.shape[0]):
        cols = np.flatnonzero(exists[i % b])
        same = a_card[i, cols] == a_cpu[i, cols]
        rows_equal.append(bool(same.all()))
        slots_equal.extend(same.tolist())
        opt = cost[i, a_cpu[i, cols], cols].sum()
        got = cost[i, a_card[i, cols], cols].sum()
        excess.append(float((got - opt) / max(abs(opt), 1e-9)))
    stages = np.asarray(rows_equal).reshape(-1, b).all(axis=1)
    return dict(matchings_equal_share=float(np.mean(rows_equal)),
                stages_equal_share=float(stages.mean()),
                slots_equal_share=float(np.mean(slots_equal)),
                max_rel_excess_cost=max(excess), rel_excess_cost=excess,
                stages=len(stages))


def phase_set_loss_card_vs_cpu(dev, cfg, label: str) -> None:
    """One train step of the Mask2Former model at 256x256 on the card
    (bf16) and on the CPU (fp32) from the same seeded weights, batch and
    point coordinates (the ``mask`` stream drawn on the CPU from one seed
    and copied to each side's device): the matchings' agreement, the loss
    entries, the cosine of the flattened adapter gradients (the config's
    ``peft.adapter_keywords``) and grad_norm."""
    ds = SyntheticDataset(n=2, hw=TRAIN_CHECK_HW,
                          num_classes=cfg["num_classes"], seed=SEED + 7)
    batch = collate([ds[0], ds[1]])
    keywords = cfg["peft"]["adapter_keywords"]

    def one_step(device, dtype):
        model = init_params(build_segmentor(
            cfg["model"], dtype=dtype, device=device,
            attn_impl=compute_attn_impl(cfg)), SEED)
        state = create_train_state(model, cfg)
        gen = torch.Generator().manual_seed(SEED + 8)
        drawn = rng.uniform

        def uniform(name, shape, to):
            return torch.rand(tuple(shape), generator=gen).to(to)

        t0 = time.perf_counter()
        rng.uniform = uniform
        try:
            with MatchRecorder() as rec:
                _, metrics = make_train_step()(state, batch, SEED)
        finally:
            rng.uniform = drawn
        metrics = {k: float(v) for k, v in metrics.items()}
        secs = time.perf_counter() - t0
        grad = torch.cat([p.grad.float().flatten().cpu()
                          for n, p in state.model.named_parameters()
                          if any(k in n for k in keywords)])
        return metrics, grad, rec, secs

    card, card_g, card_rec, card_s = one_step(dev, compute_dtype(cfg))
    cpu, cpu_g, cpu_rec, cpu_s = one_step(torch.device("cpu"), torch.float32)
    exists = m2f_loss.semantic_to_targets(
        torch.from_numpy(batch["label"]), cfg["num_classes"])[1].numpy()
    match = _assignment_checks(card_rec, cpu_rec, exists)
    rel = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-9)
           for k in cpu if "loss" in k}
    cos = float(F.cosine_similarity(card_g.double(), cpu_g.double(), dim=0))
    norm_rel = abs(card["grad_norm"] / cpu["grad_norm"] - 1)
    ok = (all(np.isfinite(list(card.values())))
          and match["max_rel_excess_cost"] <= SET_MATCH_EXCESS
          and rel["loss"] <= SET_TOTAL_REL
          and max(rel.values()) <= SET_LOSS_REL
          and cos >= SET_GRAD_COS and norm_rel <= SET_GRAD_NORM_REL)
    emit(f"{label}_train_card_vs_cpu", model=cfg["name"],
         image_hw=list(TRAIN_CHECK_HW), card=card, cpu=cpu, **match,
         excess_cost_limit=SET_MATCH_EXCESS, loss_rel_err=rel,
         total_loss_rel_limit=SET_TOTAL_REL, loss_rel_limit=SET_LOSS_REL,
         adapter_grad_cosine=cos, cosine_limit=SET_GRAD_COS,
         grad_norm_rel_err=norm_rel, grad_norm_rel_limit=SET_GRAD_NORM_REL,
         match_host_ms=dict(card=card_rec.ms, cpu=cpu_rec.ms),
         card_step_s=card_s, cpu_step_s=cpu_s, ok=ok)
    if not ok:
        raise AssertionError(f"{label} train card vs CPU: matching {match}, "
                             f"loss rel {rel}, gradient cosine {cos}, "
                             f"grad_norm rel {norm_rel}")


def synthetic_images(n: int, hw, seed: int) -> torch.Tensor:
    """Preprocessed NHWC float32 images: blocky colour fields plus noise,
    normalised with the config's mean and std."""
    rng_np = np.random.RandomState(seed)
    coarse = rng_np.randint(0, 256, (n, hw[0] // 32, hw[1] // 32, 3))
    img = np.repeat(np.repeat(coarse, 32, axis=1), 32, axis=2).astype(
        np.float32)
    img = np.clip(img + rng_np.normal(0, 12, img.shape), 0, 255)
    mean = np.asarray(PREPROCESSOR["mean"], np.float32)
    std = np.asarray(PREPROCESSOR["std"], np.float32)
    return torch.from_numpy(((img - mean) / std).astype(np.float32))


@torch.inference_mode()
def refined_windows(model, img: torch.Tensor, test_cfg: dict) -> int:
    """How many slide windows the gate sends to the refine head."""
    h, w = img.shape[1:3]
    crop = tuple(test_cfg["crop_size"])
    full = resize(model.lr_forward(resize(img, size=test_cfg["lr_img_size"])),
                  size=(h, w))
    ctx = extract_crops(full, compute_slide_grid(
        (h, w), crop, tuple(test_cfg["stride"])), crop)
    conf = confident_mask(ctx, test_cfg["threshold"]).mean(dim=(1, 2))
    return int((conf < test_cfg["conf"]).sum())


def phase_main_path(dev, cfg, label: str, hw=IMAGE_HW,
                    n_images: int = N_IMAGES) -> tuple:
    """``n_images`` synthetic ``hw`` images through the config's predictor:
    launches per image (``PER_IMAGE[label]``), labels in range, finite
    logits, latency, images/s and peak memory."""
    t0 = time.perf_counter()
    model = init_params(build_segmentor(
        cfg["model"], dtype=compute_dtype(cfg),
        attn_impl=compute_attn_impl(cfg)), SEED)
    build_secs = time.perf_counter() - t0
    test_cfg = cfg["test_cfg"]
    predict = make_shape_aware_predict_fn(model, test_cfg)
    imgs = synthetic_images(n_images, hw, SEED + 1)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    latencies, preds = [], []
    kernels.reset_launch_counts()
    for i in range(n_images):
        img = imgs[i:i + 1].to(dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        preds.append(predict(model, img, hw))
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)

    want = {k: n_images * v for k, v in PER_IMAGE[label].items()}
    if counts != want:
        raise AssertionError(f"{label} launch counts {counts} != {want}")
    for p in preds:
        if tuple(p.shape) != (1,) + tuple(hw) or not bool(
                ((p >= 0) & (p < cfg["num_classes"])).all()):
            raise AssertionError("predict returned labels of the wrong shape "
                                 "or range")
    with torch.inference_mode():
        logits = make_logits_fn(model, test_cfg, test_cfg["mode"])(
            model, imgs[:1].to(dev))
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("main-path logits are not finite")
    refined = ([refined_windows(model, imgs[i:i + 1].to(dev), test_cfg)
                for i in range(n_images)]
               if test_cfg["mode"] == "ms_slide_inference" else None)
    steady = latencies[1:] or latencies
    windows = (len(compute_slide_grid(hw, tuple(test_cfg["crop_size"]),
                                      tuple(test_cfg["stride"])))
               if "crop_size" in test_cfg else None)
    emit("main_path" if label == "dinov2" else f"{label}_main_path",
         model=cfg["name"], images=n_images, image_hw=list(hw),
         model_build_s=build_secs, latency_s=latencies,
         steady_latency_s=steady, images_per_s=len(steady) / sum(steady),
         peak_mem_bytes=peak, launches=counts,
         launches_per_image={k: v // n_images for k, v in counts.items()},
         refined_windows=refined, windows=windows,
         logits_shape=list(logits.shape))
    return model, counts


def _agreement(card: torch.Tensor, cpu: torch.Tensor) -> dict:
    """Card logits against the CPU's: the q99 error over the q99 |CPU
    logit|, the argmax agreement over every pixel and over the pixels whose
    CPU top-2 gap is at least CLEAR_GAP."""
    err = (card - cpu).abs().numpy().ravel()
    scale = float(np.quantile(np.abs(cpu.numpy()).ravel(), 0.99))
    same = card.argmax(-1) == cpu.argmax(-1)
    top2 = cpu.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) >= CLEAR_GAP
    return dict(q99_rel_drift=float(np.quantile(err, 0.99)) / max(scale,
                                                                   1e-9),
                argmax_agreement=float(same.float().mean()),
                clear_share=float(clear.float().mean()),
                clear_agreement=float(same[clear].float().mean()),
                max_abs_err=float(err.max()))


def _ln_pre(model):
    """CLIP's ``ln_pre`` (the LayerNorm after its stem), where the model
    has one."""
    return next((m for n, m in model.named_modules()
                 if n.rpartition(".")[2] == "ln_pre"), None)


def phase_card_vs_cpu(model, dev, cfg, label: str) -> None:
    """The card's logits of one CHECK_HW image against the fp32 CPU's.
    With CLIP's stem (``ln_pre``), the card runs the image a second time
    with ln_pre's input taken from the CPU's run, so that the stem's bf16
    rounding (patch embedding, class embedding and position adds) is gone
    from it: phase ``<label>_stem_from_cpu`` reads what is left."""
    test_cfg = cfg["test_cfg"]
    logits_fn = make_logits_fn(model, test_cfg, test_cfg["mode"])
    img = synthetic_images(1, CHECK_HW, SEED + 2)
    card_stems: list = []
    cpu_stems: list = []
    stem = _ln_pre(model)
    hooks = [] if stem is None else [stem.register_forward_pre_hook(
        lambda m, a: card_stems.append(a[0].float().cpu()))]
    with torch.inference_mode():
        card = logits_fn(model, img.to(dev)).float().cpu()
    cpu_model = init_params(build_segmentor(
        cfg["model"], dtype=torch.float32, device="cpu",
        attn_impl=compute_attn_impl(cfg)), SEED)
    if stem is not None:
        hooks.append(_ln_pre(cpu_model).register_forward_pre_hook(
            lambda m, a: cpu_stems.append(a[0].clone())))
    t0 = time.perf_counter()
    with torch.inference_mode():
        cpu = logits_fn(cpu_model, img)
    cpu_secs = time.perf_counter() - t0
    for hook in hooks:
        hook.remove()
    if not bool(torch.isfinite(card).all()):
        raise AssertionError("card logits are not finite")
    got = _agreement(card, cpu)
    drift, agree = got["q99_rel_drift"], got["argmax_agreement"]
    clear_agree = got["clear_agreement"]
    drift_limit, agree_limit, clear_limit = (
        (M2F_DRIFT_Q99, M2F_ARGMAX_AGREE, None) if label in ("m2f", "rein")
        else (DRIFT_Q99, CLIP_ARGMAX_AGREE, CLEAR_AGREE) if label == "clip"
        else (DRIFT_Q99, ARGMAX_AGREE, None))
    ok = (drift < drift_limit and agree >= agree_limit
          and (clear_limit is None or clear_agree >= clear_limit))
    emit("card_vs_cpu" if label == "dinov2" else f"{label}_card_vs_cpu",
         model=cfg["name"], image_hw=list(CHECK_HW), drift_limit=drift_limit,
         agreement_limit=agree_limit, clear_gap=CLEAR_GAP,
         clear_agreement_limit=clear_limit, cpu_seconds=cpu_secs, ok=ok,
         **got)
    if stem is not None:
        phase_stem_from_cpu(model, logits_fn, img, dev, stem, card_stems,
                            cpu_stems, cpu, label)
    if not ok:
        raise AssertionError(f"{label} card vs CPU: q99 drift {drift}, "
                             f"argmax agreement {agree}, beyond a top-2 gap "
                             f"of {CLEAR_GAP}: {clear_agree}")


def phase_stem_from_cpu(model, logits_fn, img, dev, stem, card_stems,
                        cpu_stems, cpu, label: str) -> None:
    """The card's run again with each ln_pre input replaced by the CPU's
    (in call order; ln_pre rounds it to bf16 once), held against the CPU's
    logits; the stem's own error, the worst over the calls of max |card -
    CPU| over max |CPU|, beside it. A call whose shape differs from the
    CPU's (a gate that picked other windows) keeps the card's input and is
    counted."""
    pairs = [(c, r) for c, r in zip(card_stems, cpu_stems)
             if c.shape == r.shape]
    stem_rel = max((float((c - r).abs().max() / r.abs().max())
                    for c, r in pairs), default=None)
    queue = list(cpu_stems)
    kept = []

    def swap(m, a):
        src = queue.pop(0) if queue else None
        if src is None or src.shape != a[0].shape:
            kept.append(list(a[0].shape))
            return None
        return (src.to(dev),)

    hook = stem.register_forward_pre_hook(swap)
    try:
        with torch.inference_mode():
            swapped = logits_fn(model, img.to(dev)).float().cpu()
    finally:
        hook.remove()
    emit(f"{label}_stem_from_cpu", ln_pre_calls=len(cpu_stems),
         card_ln_pre_calls=len(card_stems), calls_kept=kept,
         stem_rel_err=stem_rel, **_agreement(swapped, cpu))


def phase_main_breakdown(model, dev, cfg, label: str, hw=IMAGE_HW) -> None:
    """One ``hw`` image through ``predict``: the median wall time of 3
    unprofiled calls (synchronised host clock), then the kernels' device
    time over one profiled call."""
    predict = make_shape_aware_predict_fn(model, cfg["test_cfg"])
    img = synthetic_images(1, hw, SEED + 1).to(dev)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict(model, img, hw)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    image_ms = float(np.median(walls))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        predict(model, img, hw)
        torch.cuda.synchronize()
    emit("main_breakdown" if label == "dinov2"
         else f"{label}_main_breakdown", model=cfg["name"],
         image_ms=image_ms, **_breakdown(prof, image_ms))


class MemorySource:
    """An in-memory source dataset for ``DGDataset``: items ``{img,
    label}``, each with the label file name that the RCS statistics in
    ``data_root`` refer to (``sample_class_stats.json``,
    ``samples_with_class.json``, written as tools/make_synthetic_dataset.py
    writes them)."""

    def __init__(self, items: list, data_root: str):
        self.data_root = data_root
        self.items = items
        self.samples = []
        stats, with_class = [], {}
        for i, item in enumerate(items):
            path = os.path.join(data_root, "labels",
                                f"{i:05d}_labelTrainIds.png")
            self.samples.append({"seg_map_path": path})
            entry = {"file": path}
            classes, counts = np.unique(item["label"], return_counts=True)
            for c, n in zip(classes.tolist(), counts.tolist()):
                entry[str(c)] = n
                with_class.setdefault(str(c), []).append([path, n])
            stats.append(entry)
        os.makedirs(data_root, exist_ok=True)
        for name, data in (("sample_class_stats.json", stats),
                           ("samples_with_class.json", with_class)):
            with open(os.path.join(data_root, name), "w") as f:
                json.dump(data, f)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> dict:
        return dict(self.items[idx])


def _val_image(seed: int) -> dict:
    """A 1024 x 2048 labelled image of 32-pixel blocks."""
    rs = np.random.RandomState(seed)
    coarse = rs.randint(0, 256, (IMAGE_HW[0] // 32, IMAGE_HW[1] // 32, 3))
    img = np.repeat(np.repeat(coarse, 32, 0), 32, 1).astype(np.uint8)
    label = np.repeat(np.repeat(rs.randint(0, 19, coarse.shape[:2]), 32, 0),
                      32, 1).astype(np.uint8)
    return dict(img=img, label=label)


def _jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def loader_rate(cfg, source) -> dict:
    """The data pipeline alone: DGDataset (RCS) + the config's
    TrainPipeline on the config's worker threads, LOADER_SAMPLES samples
    in batches of the config's size, no model."""
    dcfg = cfg["data"]
    pipeline = TrainPipeline(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in dcfg["train_pipeline"].items()})
    dataset = DGDataset(source, pipeline, dcfg["rare_class_sampling"],
                        seed=SEED)
    bs = dcfg["batch_size"]
    t0 = time.perf_counter()
    loader = InfiniteLoader(dataset, batch_size=bs,
                            num_workers=dcfg["num_workers"], seed=SEED)
    try:
        batches = [next(loader) for _ in range(LOADER_SAMPLES // bs)]
    finally:
        loader.close()
    secs = time.perf_counter() - t0
    b = batches[0]
    crop = tuple(pipeline.crop_size)
    if b["img"].shape != (bs, *crop, 3) or b["label"].shape != (bs, *crop):
        raise AssertionError(f"loader batch shapes {b['img'].shape}, "
                             f"{b['label'].shape}")
    return dict(samples=LOADER_SAMPLES, seconds=secs,
                samples_per_s=LOADER_SAMPLES / secs,
                threads=dcfg["num_workers"]), b


def phase_train_cli(dev, smi: str) -> dict:
    """The train CLI (``tools/train.py``'s ``run``) on the headline's
    config file at full width: TRAIN_CLI_STEPS steps with checkpoints,
    validation and save_best, then ``--resume`` to TRAIN_CLI_RESUME_TO;
    launches, metrics, checkpoints and the resumed state checked; the
    loader's rate, the CLI's steps/s, one profiled step's device time and
    the CLI's idle share, peak memory and the validation's time."""
    t_phase = time.perf_counter()
    shutil.rmtree(TRAIN_CLI_DIR, ignore_errors=True)
    data_root = os.path.join(TRAIN_CLI_DIR, "data")
    work_dir = os.path.join(TRAIN_CLI_DIR, "run")
    cfg = load_config(TRAIN_CLI_CONFIG,
                      [f"data.source.data_root={data_root}",
                       *TRAIN_CLI_OPTIONS])
    if cfg["data"]["num_workers"] != 4 or cfg["data"]["batch_size"] != 2:
        raise AssertionError("the headline's data settings changed")
    t0 = time.perf_counter()
    rs = np.random.default_rng(SEED + 31)
    source = MemorySource([synthetic_sample(rs, TRAIN_CLI_SOURCE_HW, 19)
                           for _ in range(TRAIN_CLI_SAMPLES)], data_root)
    val_sets = {"citys": [_val_image(SEED + 37)]}
    data_secs = time.perf_counter() - t0
    loader_stats, batch = loader_rate(cfg, source)

    # time the validation and catch the first resumed step's state
    val_secs, resumed = [], {}
    make_val_fn, make_step = train_cli.make_val_fn, train_cli.make_train_step

    def timed_val_fn(*a, **k):
        val_fn = make_val_fn(*a, **k)

        def timed(state):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = val_fn(state)
            torch.cuda.synchronize()
            val_secs.append(time.perf_counter() - t)
            return out

        return timed

    def watched_step():
        step = make_step()

        def first(state, batch_, seed):
            if not resumed:
                resumed["step"] = state.step
                resumed["trainable"] = {
                    n: p.detach().cpu().clone()
                    for n, p in trainable_state_dict(state.model).items()}
            return step(state, batch_, seed)

        return first

    train_cli.make_val_fn = timed_val_fn
    try:
        args = train_cli.parse_args([TRAIN_CLI_CONFIG, "--work-dir",
                                     work_dir, "--max-iters",
                                     str(TRAIN_CLI_STEPS)])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state = train_cli.run(cfg, args, source=source, val_sets=val_sets)
        torch.cuda.synchronize()
        run_secs = time.perf_counter() - t0
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        train_cli.make_val_fn = make_val_fn

    want = {k: TRAIN_CLI_STEPS * PER_STEP["dinov2"][k]
            + PER_IMAGE["dinov2"][k] for k in KERNEL_NAMES}
    if counts != want:
        raise AssertionError(f"train CLI launch counts {counts} != {want}")
    records = _jsonl(os.path.join(work_dir, "metrics.jsonl"))
    train = [r for r in records if r["prefix"] == "train"]
    val = [r for r in records if r["prefix"] == "val"]
    if [r["step"] for r in train] != list(range(1, TRAIN_CLI_STEPS + 1)):
        raise AssertionError("the train CLI did not log every step")
    if not all(np.isfinite([r["loss"], r["grad_norm"]]).all()
               for r in train):
        raise AssertionError(f"non-finite train metrics {train}")
    if [r["step"] for r in val] != [TRAIN_CLI_STEPS] or not np.isfinite(
            val[0].get("citys_mIoU", np.nan)):
        raise AssertionError(f"the val line {val} lacks citys_mIoU")
    ckpt_dir = os.path.join(work_dir, "checkpoints")
    files = sorted(os.listdir(ckpt_dir))
    need = ["best.trainable.npz", "iter_0000003.trainable.npz",
            "iter_0000006.trainable.npz"]
    if not set(need) <= set(files):
        raise AssertionError(f"checkpoints {files} lack some of {need}")
    cli_step_s = [1.0 / r["steps_per_sec"] for r in train]
    steady_s = float(np.mean(cli_step_s[1:]))  # steps 2-6

    # one step of the same train step, profiled, on a loader batch
    step_fn = make_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step_fn(state, batch, SEED)
    torch.cuda.synchronize()
    unprofiled_ms = (time.perf_counter() - t0) * 1e3
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        state, _ = step_fn(state, batch, SEED)
        torch.cuda.synchronize()
    profiled = _breakdown(prof, steady_s * 1e3)
    del state, step_fn
    torch.cuda.empty_cache()

    # resume from step 6 to 8
    train_cli.make_train_step = watched_step
    try:
        args = train_cli.parse_args([TRAIN_CLI_CONFIG, "--work-dir",
                                     work_dir, "--resume", "--max-iters",
                                     str(TRAIN_CLI_RESUME_TO)])
        kernels.reset_launch_counts()
        state = train_cli.run(cfg, args, source=source, val_sets=val_sets)
        torch.cuda.synchronize()
        resume_counts = kernels.launch_counts()
    finally:
        train_cli.make_train_step = make_step
    saved = state_dict_from_flax({"params": load_pytree(os.path.join(
        ckpt_dir, "iter_0000006.trainable.npz"))["t"]}, state.model)
    got = resumed.get("trainable", {})
    differ = [n for n in got if not torch.equal(got[n], saved[n])]
    extra = TRAIN_CLI_RESUME_TO - TRAIN_CLI_STEPS
    if (resumed.get("step") != TRAIN_CLI_STEPS or not got or differ
            or state.step != TRAIN_CLI_RESUME_TO):
        raise AssertionError(f"resume: first step {resumed.get('step')}, "
                             f"end {state.step}, differing {differ[:5]}")
    want = {k: extra * v for k, v in PER_STEP["dinov2"].items()}
    if resume_counts != want:
        raise AssertionError(f"resumed launch counts {resume_counts} != "
                             f"{want}")
    steps = [r["step"] for r in _jsonl(os.path.join(work_dir,
                                                    "metrics.jsonl"))
             if r["prefix"] == "train"]
    if steps != list(range(1, TRAIN_CLI_RESUME_TO + 1)):
        raise AssertionError(f"train steps logged {steps}")
    del state
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_CLI_DIR, ignore_errors=True)
    host = {}
    for name in ("numpy", "scipy", "PIL"):
        try:
            host[name] = __import__(name).__version__
        except ImportError:
            host[name] = None
    emit("train_cli", model=cfg["name"], config=os.path.relpath(
             TRAIN_CLI_CONFIG, REPO), card=smi, batch=cfg["data"]["batch_size"],
         crop_hw=list(cfg["data"]["train_pipeline"]["crop_size"]),
         source_hw=list(TRAIN_CLI_SOURCE_HW), source_samples=TRAIN_CLI_SAMPLES,
         data_build_s=data_secs, loader=loader_stats,
         run_s=run_secs, step_s=cli_step_s,
         steps_per_s_2_to_6=1.0 / steady_s, val_s=val_secs,
         val=val[0], peak_mem_bytes=peak, launches=counts,
         resume=dict(from_step=TRAIN_CLI_STEPS, to_step=TRAIN_CLI_RESUME_TO,
                     launches=resume_counts),
         profiled_step=dict(unprofiled_ms=unprofiled_ms,
                            idle_share_basis="the CLI's mean step of "
                                             "steps 2-6", **profiled),
         host_packages=host, seconds=time.perf_counter() - t_phase)
    return {"train_cli": counts, "train_cli_resume": resume_counts}


def run_paths(dev, cfg, label: str, restore: bool) -> dict:
    """One model's inference and train paths; returns each path's launch
    counts."""
    t0 = time.perf_counter()
    model, counts = phase_main_path(dev, cfg, label)
    phase_card_vs_cpu(model, dev, cfg, label)
    phase_main_breakdown(model, dev, cfg, label)
    del model
    torch.cuda.empty_cache()
    state, train_counts = phase_train_path(dev, cfg, label, restore)
    phase_train_breakdown(dev, cfg, state, label)
    del state
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_WORK_DIR, ignore_errors=True)
    phase_train_card_vs_cpu(dev, cfg, label)
    emit(f"{label}_paths_done", seconds=time.perf_counter() - t0)
    return {f"{label}_inference": counts, f"{label}_train": train_counts}


def sam_bias_config() -> dict:
    """dg_lora_sam_ms_masked on the bias route: its config with
    ``compute.attn_impl = "pallas_bias"`` (``--cfg-options
    compute.attn_impl=pallas_bias`` on the eval CLI)."""
    cfg = sam_config()
    cfg["compute"]["attn_impl"] = "pallas_bias"
    return cfg


def run_m2f_paths(dev) -> dict:
    """dg_lora_dinov2_mask2former's slide eval at full width: 3 images
    through the predictor, card vs CPU, a profiled image (the fused
    deformable core's share of the device time), and the eval CLI's
    loop."""
    t0 = time.perf_counter()
    cfg = mask2former_config()
    model, counts = phase_main_path(dev, cfg, "m2f")
    phase_card_vs_cpu(model, dev, cfg, "m2f")
    phase_main_breakdown(model, dev, cfg, "m2f")
    phase_eval_cli(model, cfg, cfg["test_cfg"], "m2f_eval_cli")
    del model
    torch.cuda.empty_cache()
    emit("m2f_paths_done", seconds=time.perf_counter() - t0)
    return {"m2f_inference": counts}


def run_rein_paths(dev) -> dict:
    """dg_rein_dinov2_mask2former at full width: the slide eval of 3
    images, card vs CPU, a profiled image (the fused deformable core's
    share at the pyramid); 8
    train steps at bs 2, 512^2 (checkpoints at 4 and 8, a fresh state
    restored), a profiled step, and one step card vs CPU at 256^2."""
    t0 = time.perf_counter()
    cfg = config(REIN_CONFIG)
    model, counts = phase_main_path(dev, cfg, "rein")
    phase_card_vs_cpu(model, dev, cfg, "rein")
    phase_main_breakdown(model, dev, cfg, "rein")
    del model
    torch.cuda.empty_cache()
    state, train_counts = phase_train_path(dev, cfg, "rein", restore=True)
    phase_train_breakdown(dev, cfg, state, "rein")
    phase_set_loss_split(dev, cfg, state, "rein")
    del state
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_WORK_DIR, ignore_errors=True)
    phase_set_loss_card_vs_cpu(dev, cfg, "rein")
    emit("rein_paths_done", seconds=time.perf_counter() - t0)
    return {"rein_inference": counts, "rein_train": train_counts}


def run_encdec_train(dev) -> dict:
    """ENCDEC_STEPS train steps of each of ENCDEC_CONFIGS at full width,
    bs 2, 512^2 (phase encdec_train, one line a model)."""
    by_path = {}
    for label, name in ENCDEC_CONFIGS:
        state, counts = phase_train_path(dev, config(name), label,
                                         restore=False, steps=ENCDEC_STEPS,
                                         phase="encdec_train")
        del state
        torch.cuda.empty_cache()
        by_path[f"{label}_train"] = counts
    shutil.rmtree(TRAIN_WORK_DIR, ignore_errors=True)
    return by_path


def run_clip_paths(dev) -> dict:
    """LoRA CLIP-L in the MsVFM scheme at full width (drop-path 0.1): the
    dense gated inference of 3 images, card vs CPU, a profiled image,
    8 bs 2 two-scale train steps, a profiled step, one step card vs CPU at
    256^2 (phases clip_*)."""
    return run_paths(dev, config(CLIP_CONFIG), "clip", restore=False)


def run_rein_clip_paths(dev) -> dict:
    """Rein CLIP-L with its FPN under the Rein Mask2Former head: the slide
    eval of one 1024x2048 image and a profiled one, SLICE_STEPS train steps
    at bs 4, 512^2 in which ClipFPN's BatchNorm moves its statistics
    (phases rein_clip_m2f_*)."""
    t0 = time.perf_counter()
    cfg = config(REIN_CLIP_CONFIG)
    model, counts = phase_main_path(dev, cfg, "rein_clip_m2f", n_images=1)
    phase_main_breakdown(model, dev, cfg, "rein_clip_m2f")
    del model
    torch.cuda.empty_cache()
    state, train_counts = phase_train_path(
        dev, cfg, "rein_clip_m2f", restore=False, steps=SLICE_STEPS,
        phase="rein_clip_m2f_train", stats_move=("backbone.fpn.fpn1_bn.",))
    del state
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_WORK_DIR, ignore_errors=True)
    emit("rein_clip_m2f_paths_done", seconds=time.perf_counter() - t0)
    return {"rein_clip_m2f_inference": counts,
            "rein_clip_m2f_train": train_counts}


def run_hrda_paths(dev) -> dict:
    """HRDA on Rein DINOv2-L: the slide eval of one 1024x2048 image (3
    windows, each an LR pass and 9 HR crops, batched), card vs CPU at
    512x1024, a profiled image, the eval CLI's loop, SLICE_STEPS train steps
    at bs 2, 1024^2 (phases hrda_*)."""
    t0 = time.perf_counter()
    cfg = config(HRDA_CONFIG)
    model, counts = phase_main_path(dev, cfg, "hrda", n_images=1)
    phase_card_vs_cpu(model, dev, cfg, "hrda")
    phase_main_breakdown(model, dev, cfg, "hrda")
    phase_eval_cli(model, cfg, cfg["test_cfg"], "hrda_eval_cli")
    del model
    torch.cuda.empty_cache()
    state, train_counts = phase_train_path(dev, cfg, "hrda", restore=False,
                                           steps=SLICE_STEPS,
                                           phase="hrda_train")
    del state
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_WORK_DIR, ignore_errors=True)
    emit("hrda_paths_done", seconds=time.perf_counter() - t0)
    return {"hrda_inference": counts, "hrda_train": train_counts}


def run_segformer_paths(dev) -> dict:
    """Rein DINOv2-L + SegformerHead: the slide eval of one image and a
    profiled one, SLICE_STEPS train steps at bs 2, 512^2 (phases
    segformer_*)."""
    cfg = config(SEGFORMER_CONFIG)
    model, counts = phase_main_path(dev, cfg, "segformer", n_images=1)
    phase_main_breakdown(model, dev, cfg, "segformer")
    del model
    torch.cuda.empty_cache()
    state, train_counts = phase_train_path(
        dev, cfg, "segformer", restore=False, steps=SLICE_STEPS,
        phase="segformer_train")
    del state
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_WORK_DIR, ignore_errors=True)
    return {"segformer_inference": counts, "segformer_train": train_counts}


def mit_config():
    """The MiT-B5 + DAFormer sep-ASPP base, with the batch of 2 its dataset
    files would give it."""
    cfg = config(MIT_CONFIG)
    cfg["data"] = {"batch_size": 2}
    return cfg


def run_mit_paths(dev) -> tuple:
    """MiT-B5 + DAFormer (sep-ASPP): B1 at MiT's LayerNorm shapes and B5's
    forward and fused backward at the three MiT stage shapes against the
    plain versions (events, SDPA, bound); the whole inference of one
    512x1024 image, card vs CPU and a profiled image; SLICE_STEPS train
    steps at bs 2, 512^2 and a profiled step (phases kernel_layer_norm_mit,
    kernel_attention_hm_mit, mit_*). Returns B5's rows, B1's rows and each
    path's launches."""
    t0 = time.perf_counter()
    ln_rows = check_layer_norm(_randn(np.random.RandomState(SEED + 32),
                                      dev), MIT_LN_CASES,
                               "kernel_layer_norm_mit")
    rows = check_headmajor(_randn(np.random.RandomState(SEED + 31), dev),
                           dev, MIT_HM_SHAPES, "kernel_attention_hm_mit",
                           kv_fused=True)
    cfg = mit_config()
    model, counts = phase_main_path(dev, cfg, "mit", hw=MIT_HW, n_images=1)
    phase_card_vs_cpu(model, dev, cfg, "mit")
    phase_main_breakdown(model, dev, cfg, "mit", hw=MIT_HW)
    del model
    torch.cuda.empty_cache()
    state, train_counts = phase_train_path(dev, cfg, "mit", restore=False,
                                           steps=SLICE_STEPS,
                                           phase="mit_train")
    phase_train_breakdown(dev, cfg, state, "mit")
    del state
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_WORK_DIR, ignore_errors=True)
    emit("mit_paths_done", seconds=time.perf_counter() - t0)
    return rows, ln_rows, {"mit_inference": counts,
                           "mit_train": train_counts}


def _mit_rows(summary: list, rows: list, ln_rows: list) -> None:
    """B5's summary rows carry its MiT shapes: each shape's events ms and
    graph ms (``graph_ms``: events count the host's gaps for calls of tens
    of microseconds), plain, SDPA (events and graph ms) and bound, and the
    worst error over them too; B1's row the worst error over MiT's
    LayerNorm shapes."""
    ln = next(r for r in summary if r["name"] == "layer_norm")
    ln["max_abs_err"] = max([ln["max_abs_err"]]
                            + [r["max_abs_err"] for r in ln_rows])
    for name, kind in (("attention_hm_fwd", "fwd"),
                       ("attention_hm_bwd", "bwd")):
        row = next(r for r in summary if r["name"] == name)
        row["mit_shapes"] = [dict(
            shape=r["shape"], ms=r[f"{kind}_ms"],
            graph_ms=r[f"{kind}_graph_ms"],
            plain_ms=r[f"{kind}_plain_ms"],
            library_ms=r[f"{kind}_library_ms"],
            library_graph_ms=r[f"{kind}_library_graph_ms"],
            bound_ms=r[f"{kind}_bound"]["bound_ms"],
            bound_by=r[f"{kind}_bound"]["bound_by"]) for r in rows]
        errs = [r["out_max_abs_err"] if kind == "fwd"
                else max(r["grad_rel_err"].values()) for r in rows]
        row["max_abs_err"] = max([row["max_abs_err"]] + errs)


# ------------------------------------------------- A10: DG and DACS ----

def _deterministic(cfg: dict) -> dict:
    """Every dropout, drop-path and mask ratio of a model config at 0, in
    place (the card-vs-CPU checks draw them on different devices)."""
    for key, val in list(cfg.items()):
        if isinstance(val, dict):
            _deterministic(val)
        elif key in ("dropout_ratio", "lora_dropout", "drop_path_rate",
                     "dropout"):
            cfg[key] = 0.0
    return cfg


def phase_dg_wrapped_prediction(dev, cfg, model) -> dict:
    """The dense gated logits of one IMAGE_HW image through the
    DomainGeneral wrapper and through its inner model (``unwrap_model``):
    the wrapper adds no computation, so they must be bit-equal; launches
    per image as the headline's."""
    model.eval()
    test_cfg = cfg["test_cfg"]
    img = synthetic_images(1, IMAGE_HW, SEED + 3).to(dev)
    logits_fn = make_logits_fn(model, test_cfg, test_cfg["mode"])
    with torch.inference_mode():
        kernels.reset_launch_counts()
        inner = logits_fn(unwrap_model(model), img)
        counts = kernels.launch_counts()
        wrapped = logits_fn(model, img)
    torch.cuda.synchronize()
    equal = bool(torch.equal(inner, wrapped))
    emit("dg_wrapped_prediction", model=cfg["name"], image_hw=list(IMAGE_HW),
         mode=test_cfg["mode"], bit_equal=equal,
         max_abs_diff=float((inner - wrapped).abs().max()),
         finite=bool(torch.isfinite(inner).all()), launches=counts)
    if not equal or counts != PER_IMAGE["dinov2"]:
        raise AssertionError(f"DomainGeneral's prediction differs from its "
                             f"inner model's (bit-equal {equal}) or launched "
                             f"{counts}")
    return counts


def run_dg_paths(dev) -> dict:
    """dg_lora_dinov2_ms_masked_consistency (the headline in DomainGeneral
    with the mask branch) at full width: DG_STEPS bs 2, 1024^2 steps through
    train_loop (launches a step, mask.* losses finite and nonzero), a
    profiled step, the wrapped dense prediction bit-equal to the inner
    model's on one 1024x2048 image, and one 256^2 step card vs CPU with the
    same host draws (phases dg_*)."""
    t0 = time.perf_counter()
    cfg = config(DG_CONFIG)
    state, counts = phase_train_path(dev, cfg, "dg", restore=False,
                                     steps=DG_STEPS, phase="dg_consistency")
    records = _jsonl(os.path.join(TRAIN_WORK_DIR, "metrics.jsonl"))
    mask_keys = [k for k in records[0] if k.startswith("mask.")
                 and "loss" in k]
    if not mask_keys or not all(np.isfinite(r[k]) and r[k] > 0
                                for r in records for k in mask_keys):
        raise AssertionError(f"DG mask losses missing or not positive: "
                             f"{records}")
    phase_train_breakdown(dev, cfg, state, "dg")
    phase_dg_wrapped_prediction(dev, cfg, state.model)
    del state
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_WORK_DIR, ignore_errors=True)
    phase_train_card_vs_cpu(dev, cfg, "dg")
    emit("dg_paths_done", seconds=time.perf_counter() - t0)
    return {"dg_train": counts}


class UDASynthetic:
    """Synthetic source samples, each with a synthetic target image: the
    items ``UDADataset`` gives (normalised, at one size)."""

    def __init__(self, n: int, hw, num_classes: int, seed: int):
        self.src = SyntheticDataset(n=n, hw=hw, num_classes=num_classes,
                                    seed=seed)
        self.tgt = SyntheticDataset(n=n, hw=hw, num_classes=num_classes,
                                    seed=seed + 100)

    def __len__(self):
        return len(self.src)

    def __getitem__(self, idx: int) -> dict:
        return dict(self.src[idx], target_img=self.tgt[idx]["img"])


class EMAWatch:
    """A DACS step that checks the EMA head after steps 0 and 1: equal to
    the updated head (alpha 0), then the mean of the two heads (alpha 0.5,
    the EMA's own arithmetic)."""

    def __init__(self, step_fn, head_key: str = "decode_head"):
        self.step_fn, self.head_key = step_fn, head_key
        self.checks, self.pseudo_weight, self._after0 = {}, [], None

    def __call__(self, state, batch, seed):
        i = state.step
        state, metrics = self.step_fn(state, batch, seed)
        self.pseudo_weight.append(float(metrics["pseudo_weight"]))
        head = {f"{self.head_key}.{n}": p.detach().float()
                for n, p in getattr(state.model,
                                    self.head_key).named_parameters()}
        if i == 0:
            self._after0 = {n: p.clone() for n, p in head.items()}
            self.checks["step0_equal_head"] = all(
                torch.equal(state.ema[n], p) for n, p in head.items())
        elif i == 1:
            err = max(float((state.ema[n] - (self._after0[n] * 0.5
                                             + p * 0.5)).abs().max())
                      for n, p in head.items())
            moved = any(not torch.equal(state.ema[n], self._after0[n])
                        for n in head)
            self.checks["step1_alpha_half_max_abs_err"] = err
            self.checks["step1_moved"] = moved
            self._after0 = None
        return state, metrics

    def verify(self) -> None:
        c = self.checks
        if not (c.get("step0_equal_head") and c.get("step1_moved")
                and c.get("step1_alpha_half_max_abs_err", 1.0) <= 1e-6):
            raise AssertionError(f"the EMA did not move as DACS's: {c}")


def phase_uda_calibrated(dev, cfg, state, batch, dacs, label: str) -> dict:
    """``pseudo_weight`` at the config's threshold (about 0 with seeded
    weights, which silences the mixed loss), then at a threshold set to
    the median of the teacher's top probability on the target batch: there
    pseudo_weight must lie in PSEUDO_WEIGHT_RANGE and the mix.* losses and
    their gradient with respect to the trainable parameters be nonzero."""
    model = state.model
    src, lbl, tgt = (torch.as_tensor(batch[k]).to(dev)
                     for k in ("img", "label", "target_img"))
    top = torch.softmax(teacher_logits(model, state.ema, tgt).float(),
                        dim=-1).amax(dim=-1)
    threshold = float(torch.quantile(top.flatten(), 0.5))
    calibrated = dataclasses.replace(dacs, pseudo_threshold=threshold)
    out = {}
    for name, c in (("config", dacs), ("calibrated", calibrated)):
        with rng.streams(step_generators(SEED, state.step, dev)):
            out[name] = dacs_mix(model, c, state.ema, src, lbl, tgt)
    pw = float(out["calibrated"]["pseudo_weight"])
    model.train()
    losses = student_losses(model, src, lbl, out["calibrated"], SEED,
                            state.step)
    mix_loss = sum(v for k, v in losses.items()
                   if k.startswith("mix.") and "loss" in k)
    params = [p for p in model.parameters() if p.requires_grad]
    grads = torch.autograd.grad(mix_loss, params, allow_unused=True)
    grad_norm = float(torch.sqrt(sum(g.float().pow(2).sum()
                                     for g in grads if g is not None)))
    mix = {k: float(v.detach()) for k, v in losses.items()
           if k.startswith("mix.")}
    del losses, mix_loss, grads
    ok = (PSEUDO_WEIGHT_RANGE[0] <= pw <= PSEUDO_WEIGHT_RANGE[1]
          and all(v > 0 for k, v in mix.items() if "loss" in k)
          and grad_norm > 0 and bool(np.isfinite(grad_norm)))
    row = dict(config_threshold=dacs.pseudo_threshold,
               pseudo_weight_at_config=float(out["config"]["pseudo_weight"]),
               calibrated_threshold=threshold, pseudo_weight=pw,
               pseudo_weight_range=list(PSEUDO_WEIGHT_RANGE),
               mix_losses=mix, mix_grad_norm=grad_norm, ok=ok)
    emit(f"{label}_calibrated", model=cfg["name"], **row)
    if not ok:
        raise AssertionError(f"{label}: calibrated DACS check failed {row}")
    torch.cuda.empty_cache()
    return row


def _teacher_counts(state, batch, dev) -> dict:
    """The launches of one teacher pass over a target batch."""
    tgt = torch.as_tensor(batch["target_img"]).to(dev)
    kernels.reset_launch_counts()
    teacher_logits(state.model, state.ema, tgt)
    torch.cuda.synchronize()
    return kernels.launch_counts()


def _check_ema_checkpoint(state, path: str) -> None:
    """The ``ema`` file of a checkpoint holds the state's EMA."""
    saved = state_dict_from_flax(
        {"params": {state.ema_key: load_npz_tree(path, "e")}}, state.model)
    differ = [n for n, v in state.ema.items()
              if not torch.equal(v.cpu(), saved[n])]
    if saved.keys() != state.ema.keys() or differ:
        raise AssertionError(f"the EMA checkpoint differs: {differ[:5]}")


def phase_uda_train(dev, cfg, label: str, steps: int) -> tuple:
    """``steps`` DACS steps of ``cfg`` at full width through train_loop
    over synthetic source and target batches (2 loader threads): launches
    a step (``PER_STEP[label]``) and the teacher's alone, finite losses,
    the EMA's first two moves (``EMAWatch``), the last checkpoint's EMA,
    steps/s and peak memory; then ``phase_uda_calibrated``. Returns the
    state, the launches and the median step of steps 2 on, in s."""
    shutil.rmtree(TRAIN_WORK_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    model = init_params(build_segmentor(
        cfg["model"], dtype=compute_dtype(cfg),
        attn_impl=compute_attn_impl(cfg)), SEED)
    state = create_train_state(model, cfg)
    dacs = train_cli.dacs_config(cfg)
    state.ema, state.ema_key = init_ema(model, dacs.head_key), dacs.head_key
    build_secs = time.perf_counter() - t0
    dataset = UDASynthetic(4, tuple(cfg["crop_size"]), cfg["num_classes"],
                           SEED)
    loader = InfiniteLoader(dataset, batch_size=cfg["data"]["batch_size"],
                            num_workers=2, seed=SEED)
    watch = EMAWatch(make_dacs_train_step(dacs), dacs.head_key)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        state = train_loop(state, watch, loader, max_iters=steps,
                           work_dir=TRAIN_WORK_DIR, seed=SEED,
                           log_interval=1, checkpoint_interval=steps,
                           max_keep_ckpts=1)
    finally:
        loader.close()
    torch.cuda.synchronize()
    loop_secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    want = {k: steps * v for k, v in PER_STEP[label].items()}
    if counts != want:
        raise AssertionError(f"{label} DACS launch counts {counts} != "
                             f"{want}")
    watch.verify()
    records = _jsonl(os.path.join(TRAIN_WORK_DIR, "metrics.jsonl"))
    if [r["step"] for r in records] != list(range(1, steps + 1)):
        raise AssertionError("train_loop did not log every step")
    losses = {k: [r[k] for r in records] for k in records[0]
              if "loss" in k or k == "pseudo_weight"}
    if not all(np.isfinite(v).all() for v in losses.values()) or not any(
            k.startswith("mix.") for k in losses):
        raise AssertionError(f"DACS metrics {losses}")
    _check_ema_checkpoint(state, os.path.join(
        TRAIN_WORK_DIR, "checkpoints", f"iter_{steps:07d}.ema.npz"))
    batch = collate([dataset[0], dataset[1]])
    teacher = _teacher_counts(state, batch, dev)
    latency = [1.0 / r["steps_per_sec"] for r in records]
    emit(label, model=cfg["name"], steps=steps,
         batch=cfg["data"]["batch_size"], crop_hw=list(cfg["crop_size"]),
         student_passes=1 if type(model).__name__ == "EncoderDecoder" else 2,
         model_build_s=build_secs, loop_s=loop_secs, step_latency_s=latency,
         steps_per_s=1.0 / float(np.median(latency[1:])),
         peak_mem_bytes=peak, launches=counts,
         launches_per_step={k: v // steps for k, v in counts.items()},
         teacher_launches=teacher, losses=losses, ema=watch.checks)
    phase_uda_calibrated(dev, cfg, state, batch, dacs, label)
    return state, counts, float(np.median(latency[1:]))


def run_uda_m2f(dev) -> dict:
    """uda_rein_dinov2_mask2former_512x512 (sequential student passes, the
    set loss scaled by the mean pixel weight; B8 at the Rein pyramid's
    train shapes, the teacher's pixel decoder on the fused deformable
    core): UDA_M2F_STEPS DACS steps, a profiled step (phases
    uda_m2f*)."""
    t0 = time.perf_counter()
    cfg = config(UDA_M2F_CONFIG)
    state, counts, step_s = phase_uda_train(dev, cfg, "uda_m2f",
                                            UDA_M2F_STEPS)
    phase_uda_breakdown(dev, cfg, state, "uda_m2f", step_ms=step_s * 1e3)
    del state
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_WORK_DIR, ignore_errors=True)
    emit("uda_m2f_done", seconds=time.perf_counter() - t0)
    return {"uda_m2f_train": counts}


def run_uda_hrda(dev) -> dict:
    """uda_rein_dinov2_hrda_1024x1024 (sequential, the HR crop's pixel
    weight cut from its box): UDA_HRDA_STEPS DACS steps (phases
    uda_hrda*)."""
    t0 = time.perf_counter()
    cfg = config(UDA_HRDA_CONFIG)
    state, counts, _ = phase_uda_train(dev, cfg, "uda_hrda",
                                       UDA_HRDA_STEPS)
    del state
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_WORK_DIR, ignore_errors=True)
    emit("uda_hrda_done", seconds=time.perf_counter() - t0)
    return {"uda_hrda_train": counts}


def phase_uda_breakdown(dev, cfg, state, label: str,
                        step_ms: float = None) -> dict:
    """One more DACS step, synchronised wall time, then a profiled one:
    the kernels' device time by family and the idle share against
    ``step_ms`` (the loop's steady step), or else the unprofiled step."""
    ds = UDASynthetic(2, tuple(cfg["crop_size"]), cfg["num_classes"],
                      SEED + 5)
    batch = collate([ds[0], ds[1]])
    step_fn = make_dacs_train_step(train_cli.dacs_config(cfg))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step_fn(state, batch, SEED)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        state, _ = step_fn(state, batch, SEED)
        torch.cuda.synchronize()
    row = dict(unprofiled_step_ms=wall_ms,
               **_breakdown(prof, step_ms or wall_ms))
    emit(f"{label}_breakdown", model=cfg["name"], **row)
    return row


def uda_loader_rate(cfg, source, target) -> tuple:
    """The UDA data pipeline alone: UDADataset (RCS source, a target
    sample an item) + the config's TrainPipeline on its worker threads,
    LOADER_SAMPLES samples, no model."""
    dcfg = cfg["data"]
    pipeline = TrainPipeline(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in dcfg["train_pipeline"].items()})
    dataset = UDADataset(source, target, pipeline,
                         rare_class_sampling=dcfg.get("rare_class_sampling"),
                         seed=SEED)
    bs = dcfg["batch_size"]
    t0 = time.perf_counter()
    loader = InfiniteLoader(dataset, batch_size=bs,
                            num_workers=dcfg["num_workers"], seed=SEED)
    try:
        batches = [next(loader) for _ in range(LOADER_SAMPLES // bs)]
    finally:
        loader.close()
    secs = time.perf_counter() - t0
    b = batches[0]
    crop = tuple(pipeline.crop_size)
    if b["target_img"].shape != (bs, *crop, 3):
        raise AssertionError(f"UDA batch shapes {b['target_img'].shape}")
    return dict(samples=LOADER_SAMPLES, seconds=secs,
                samples_per_s=LOADER_SAMPLES / secs,
                threads=dcfg["num_workers"]), b


def phase_uda_card_vs_cpu(dev, cfg, label: str) -> dict:
    """One DACS step of ``cfg`` at UDA_CHECK_HW on the card (bf16) and on
    the CPU (fp32) from the same seeded weights and host draws, dropout
    off, at a pseudo_threshold set to the median of the CPU teacher's top
    probability: the teachers' argmax agreement over all pixels and beyond
    a top-2 gap of CLEAR_GAP, pseudo_weight, the loss entries and the
    trainable gradients' cosine (TEACHER_AGREE, CLEAR_AGREE,
    PSEUDO_WEIGHT_ABS, TRAIN_LOSS_REL, TRAIN_GRAD_COS)."""
    c = copy.deepcopy(cfg)
    _deterministic(c["model"])
    ds = UDASynthetic(2, UDA_CHECK_HW, c["num_classes"], SEED + 9)
    batch = collate([ds[0], ds[1]])
    tgt = torch.from_numpy(batch["target_img"])

    def state_on(device, dtype):
        model = init_params(build_segmentor(
            c["model"], dtype=dtype, device=device,
            attn_impl=compute_attn_impl(c)), SEED)
        state = create_train_state(model, c)
        state.ema = init_ema(model)
        return state

    runs = {}
    for side, device, dtype in (("cpu", torch.device("cpu"), torch.float32),
                                ("card", dev, compute_dtype(cfg))):
        state = state_on(device, dtype)
        probs = torch.softmax(teacher_logits(
            state.model, state.ema, tgt.to(device)).float(), dim=-1).cpu()
        if side == "cpu":
            threshold = float(torch.quantile(probs.amax(-1).flatten(), 0.5))
            dacs = dataclasses.replace(train_cli.dacs_config(c),
                                       pseudo_threshold=threshold)
        t0 = time.perf_counter()
        _, metrics = make_dacs_train_step(dacs)(state, batch, SEED)
        metrics = {k: float(v) for k, v in metrics.items()}
        secs = time.perf_counter() - t0
        grad = torch.cat([p.grad.float().flatten().cpu()
                          for p in state.model.parameters()
                          if p.requires_grad])
        runs[side] = dict(probs=probs, metrics=metrics, grad=grad, secs=secs)
        del state
    card, cpu = runs["card"], runs["cpu"]
    same = card["probs"].argmax(-1) == cpu["probs"].argmax(-1)
    agree = float(same.float().mean())
    top2 = torch.log(cpu["probs"]).topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) >= CLEAR_GAP
    clear_agree = float(same[clear].float().mean())
    pw_err = abs(card["metrics"]["pseudo_weight"]
                 - cpu["metrics"]["pseudo_weight"])
    rel = {k: abs(card["metrics"][k] - v) / max(abs(v), 1e-9)
           for k, v in cpu["metrics"].items() if "loss" in k}
    cos = float(F.cosine_similarity(card["grad"].double(),
                                    cpu["grad"].double(), dim=0))
    ok = (agree >= TEACHER_AGREE and clear_agree >= CLEAR_AGREE
          and pw_err <= PSEUDO_WEIGHT_ABS
          and max(rel.values()) <= TRAIN_LOSS_REL and cos >= TRAIN_GRAD_COS
          and bool(np.isfinite(list(card["metrics"].values())).all()))
    row = dict(image_hw=list(UDA_CHECK_HW), threshold=threshold,
               teacher_argmax_agreement=agree, agreement_limit=TEACHER_AGREE,
               clear_gap=CLEAR_GAP, clear_share=float(clear.float().mean()),
               clear_agreement=clear_agree,
               clear_agreement_limit=CLEAR_AGREE,
               pseudo_weight_card=card["metrics"]["pseudo_weight"],
               pseudo_weight_cpu=cpu["metrics"]["pseudo_weight"],
               pseudo_weight_abs_err=pw_err,
               pseudo_weight_limit=PSEUDO_WEIGHT_ABS, card=card["metrics"],
               cpu=cpu["metrics"], loss_rel_err=rel,
               loss_rel_limit=TRAIN_LOSS_REL, grad_cosine=cos,
               cosine_limit=TRAIN_GRAD_COS,
               grad_norm_card=float(card["grad"].norm()),
               grad_norm_cpu=float(cpu["grad"].norm()),
               card_step_s=card["secs"], cpu_step_s=cpu["secs"], ok=ok)
    emit(f"{label}_card_vs_cpu", model=cfg["name"], **row)
    if not ok:
        raise AssertionError(f"{label} DACS card vs CPU: {row}")
    return row


def phase_uda_cli(dev) -> dict:
    """uda_rein_dinov2_segformer_512x512 (exactly EncoderDecoder: one 2B
    student pass) through the train CLI (``tools/train.py``'s ``run``) at
    full width in bf16: 8 in-memory GTA-frame source samples with RCS
    statistics in a temporary data root and 4 Cityscapes-frame target
    images, through the config's pipeline (scale jitter, 512^2 crop, flip,
    photometric distortion) on 4 loader threads; UDA_CLI_STEPS steps with
    a checkpoint (ema included) at the last. Launches a step, the EMA's
    first moves, the logged metrics; the loader's samples/s, the CLI's
    steps/s, a profiled DACS step's device time and idle share, peak
    memory; then the calibrated threshold and one step card vs CPU."""
    t_phase = time.perf_counter()
    shutil.rmtree(UDA_CLI_DIR, ignore_errors=True)
    data_root = os.path.join(UDA_CLI_DIR, "data")
    work_dir = os.path.join(UDA_CLI_DIR, "run")
    cfg = load_config(UDA_SEGFORMER_CONFIG, [
        f"data.source.data_root={data_root}", "schedule.log_interval=1",
        f"schedule.checkpoint_interval={UDA_CLI_STEPS}",
        "schedule.val_interval=0"])
    t0 = time.perf_counter()
    rs = np.random.default_rng(SEED + 41)
    source = MemorySource([synthetic_sample(rs, TRAIN_CLI_SOURCE_HW, 19)
                           for _ in range(TRAIN_CLI_SAMPLES)], data_root)
    target = [dict(img=synthetic_sample(rs, TARGET_HW, 19)["img"])
              for _ in range(4)]
    data_secs = time.perf_counter() - t0
    loader_stats, batch = uda_loader_rate(cfg, source, target)

    watches = []
    make_step = train_cli.make_dacs_train_step

    def watched(dacs):
        watches.append(EMAWatch(make_step(dacs), dacs.head_key))
        return watches[-1]

    train_cli.make_dacs_train_step = watched
    try:
        args = train_cli.parse_args([UDA_SEGFORMER_CONFIG, "--work-dir",
                                     work_dir, "--max-iters",
                                     str(UDA_CLI_STEPS)])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state = train_cli.run(cfg, args, source=source, val_sets={},
                              target=target)
        torch.cuda.synchronize()
        run_secs = time.perf_counter() - t0
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        train_cli.make_dacs_train_step = make_step
    want = {k: UDA_CLI_STEPS * v for k, v in PER_STEP["uda_segformer"].items()}
    if counts != want:
        raise AssertionError(f"UDA CLI launch counts {counts} != {want}")
    watches[0].verify()
    train = [r for r in _jsonl(os.path.join(work_dir, "metrics.jsonl"))
             if r["prefix"] == "train"]
    if [r["step"] for r in train] != list(range(1, UDA_CLI_STEPS + 1)):
        raise AssertionError("the train CLI did not log every step")
    keys = {"src.decode.loss_ce", "mix.decode.loss_ce", "loss",
            "pseudo_weight"}
    if not all(keys <= r.keys() and np.isfinite([r[k] for k in keys]).all()
               for r in train):
        raise AssertionError(f"UDA CLI metrics {train}")
    ckpt = os.path.join(work_dir, "checkpoints",
                        f"iter_{UDA_CLI_STEPS:07d}.ema.npz")
    _check_ema_checkpoint(state, ckpt)
    cli_step_s = [1.0 / r["steps_per_sec"] for r in train]
    steady_s = float(np.mean(cli_step_s[1:]))
    profiled = phase_uda_breakdown(dev, cfg, state, "uda_segformer",
                                   step_ms=steady_s * 1e3)
    teacher = _teacher_counts(state, batch, dev)
    calibrated = phase_uda_calibrated(dev, cfg, state, batch,
                                      train_cli.dacs_config(cfg),
                                      "uda_segformer")
    del state
    torch.cuda.empty_cache()
    shutil.rmtree(UDA_CLI_DIR, ignore_errors=True)
    emit("uda_segformer", model=cfg["name"], batch=cfg["data"]["batch_size"],
         crop_hw=list(cfg["data"]["train_pipeline"]["crop_size"]),
         student_passes=1, data_build_s=data_secs, loader=loader_stats,
         run_s=run_secs, step_s=cli_step_s,
         steps_per_s_2_to_last=1.0 / steady_s, peak_mem_bytes=peak,
         launches=counts,
         launches_per_step={k: v // UDA_CLI_STEPS for k, v in counts.items()},
         teacher_launches=teacher, ema=watches[0].checks,
         pseudo_weight=[r["pseudo_weight"] for r in train],
         losses={k: [r[k] for r in train] for k in sorted(keys)},
         idle_share=profiled["idle_share"],
         calibrated_threshold=calibrated["calibrated_threshold"],
         seconds=time.perf_counter() - t_phase)
    phase_uda_card_vs_cpu(dev, cfg, "uda_segformer")
    return {"uda_segformer": counts}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _write_gta_set(root: str, n: int) -> None:
    """``n`` labelled 1024 x 2048 frames as a GTA-layout PNG set."""
    from PIL import Image

    for sub in ("images", "labels"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        item = _val_image(SEED + 71 + i)
        Image.fromarray(item["img"]).save(
            os.path.join(root, "images", f"f{i}.png"))
        Image.fromarray(item["label"]).save(
            os.path.join(root, "labels", f"f{i}_labelTrainIds.png"))


def _timed_steps(step_fn, state, batch, n: int) -> float:
    """The mean wall ms of ``n`` steps after one warm-up, synchronised."""
    state, _ = step_fn(state, batch, SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state, _ = step_fn(state, batch, SEED)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def phase_ddp_world1(dev, smi: str) -> dict:
    """Data parallelism at world size 1 on NCCL (``parallel/mesh.py``): the
    headline's train CLI for DDP_STEPS steps without ``--distributed`` and
    with it (torchrun's variables set here: one rank, a free port on
    127.0.0.1), on an in-memory source at the crop size (no resize, one
    loader thread, so both runs see the same batches): the first step's
    losses bit-identical (the collectives at world 1 change no value before
    the backward), later losses within DDP_LOSS_REL and the weights within
    AdamW's 2 lr a step; the CLI's steady step times of both runs and a
    fixed batch's step with and without the group, and the gradient
    all-reduce alone: what the collectives cost on one rank. Then the eval
    CLI on DDP_EVAL_IMAGES PNG frames, plain and at ``--data-parallel 1``,
    from the run's checkpoint and its backbone: equal metrics. The group
    is destroyed at the end, so later phases run without one."""
    t_phase = time.perf_counter()
    shutil.rmtree(DDP_DIR, ignore_errors=True)
    data_root = os.path.join(DDP_DIR, "data")
    crop = (1024, 1024)
    options = [f"data.source.data_root={data_root}",
               "data.rare_class_sampling=None", "data.num_workers=1",
               f"data.train_pipeline.resize_scale_wh={crop}",
               "schedule.log_interval=1",
               f"schedule.checkpoint_interval={DDP_STEPS}",
               "schedule.val_interval=0"]
    cfg = load_config(TRAIN_CLI_CONFIG, options)
    rs = np.random.default_rng(SEED + 67)
    source = MemorySource([synthetic_sample(rs, crop, 19)
                           for _ in range(DDP_SAMPLES)], data_root)
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    runs = {}
    try:
        for tag in ("plain", "distributed"):
            if tag == "distributed":
                os.environ.update(env)
            work_dir = os.path.join(DDP_DIR, tag)
            argv = [TRAIN_CLI_CONFIG, "--work-dir", work_dir, "--max-iters",
                    str(DDP_STEPS)]
            args = train_cli.parse_args(
                argv + (["--distributed"] if tag == "distributed" else []))
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            state = train_cli.run(cfg, args, source=source, val_sets={})
            torch.cuda.synchronize()
            records = [r for r in _jsonl(os.path.join(work_dir,
                                                      "metrics.jsonl"))
                       if r["prefix"] == "train"]
            runs[tag] = dict(
                state=state, records=records, run_s=time.perf_counter() - t0,
                counts=kernels.launch_counts(),
                trainable={n: p.detach().float().cpu().clone()
                           for n, p in trainable_state_dict(
                               state.model).items()})
            if tag == "plain":
                del state
                runs[tag].pop("state")
                torch.cuda.empty_cache()
        if torch.distributed.get_backend() != "nccl" or (
                torch.distributed.get_world_size() != 1):
            raise AssertionError("--distributed did not join a one-rank "
                                 "NCCL group")
        plain, dist_run = runs["plain"], runs["distributed"]
        if plain["counts"] != dist_run["counts"]:
            raise AssertionError(f"launches differ: {plain['counts']} != "
                                 f"{dist_run['counts']}")
        loss_keys = sorted(k for k in plain["records"][0] if "loss" in k)
        first_equal = all(plain["records"][0][k] == dist_run["records"][0][k]
                          for k in loss_keys)
        later_rel = max(
            abs(a[k] - b[k]) / max(abs(a[k]), 1e-9)
            for a, b in zip(plain["records"][1:], dist_run["records"][1:])
            for k in loss_keys)
        lr = cfg["optimizer"]["lr"]
        param_bound = 2 * lr * DDP_STEPS * 1.05
        param_diff = max(float((plain["trainable"][n]
                                - dist_run["trainable"][n]).abs().max())
                         for n in plain["trainable"])
        cli_step_s = {tag: [1.0 / r["steps_per_sec"] for r in run["records"]]
                      for tag, run in runs.items()}

        # one fixed batch's step inside the group and without it, and the
        # gradient all-reduce alone
        state = dist_run["state"]
        batch = collate([DGDataset(source, TrainPipeline(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in cfg["data"]["train_pipeline"].items()}),
            seed=SEED)[i] for i in range(2)])
        step_fn = make_train_step()
        with_group_ms = _timed_steps(step_fn, state, batch, DDP_TIMED_STEPS)
        params = [p for g in state.optimizer.param_groups
                  for p in g["params"]]
        allreduce_ms = time_ms(lambda: mesh.average_gradients(params))
        bucket_mb = sum(p.numel() for p in params) * 4 / 2**20

        # the eval CLI, plain and at --data-parallel 1, from the
        # distributed run's checkpoint and its backbone
        eval_root = os.path.join(DDP_DIR, "eval")
        _write_gta_set(os.path.join(eval_root, "synth"), DDP_EVAL_IMAGES)
        frozen = {n: p for n, p in state.model.named_parameters()
                  if n.startswith("backbone.") and not p.requires_grad}
        backbone = os.path.join(eval_root, "backbone.npz")
        save_pytree(backbone, flax_from_state_dict(
            frozen, state.model)["params"]["backbone"])
        ckpt = os.path.join(DDP_DIR, "distributed", "checkpoints",
                            f"iter_{DDP_STEPS:07d}.trainable.npz")
        test_args = [TRAIN_CLI_CONFIG, ckpt, "--backbone", backbone,
                     "--max-images", str(DDP_EVAL_IMAGES), "--cfg-options",
                     "data.test=[{'type': 'GTADataset', 'data_root': "
                     f"{os.path.join(eval_root, 'synth')!r}, "
                     "'key': 'synth'}]"]
        metrics = {}
        for tag, extra in (("plain", []), ("data_parallel_1",
                                           ["--data-parallel", "1"])):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            metrics[tag] = dict(results=test_cli.main(test_args + extra),
                                seconds=time.perf_counter() - t0,
                                counts=kernels.launch_counts())
    finally:
        mesh.shutdown()
        for k in env:
            os.environ.pop(k, None)
    # the same step on the same batch without a process group
    without_group_ms = _timed_steps(step_fn, state, batch, DDP_TIMED_STEPS)
    del state, step_fn, params, dist_run["state"]
    torch.cuda.empty_cache()
    eval_equal = (metrics["plain"]["results"]
                  == metrics["data_parallel_1"]["results"])
    ok = (first_equal and later_rel <= DDP_LOSS_REL
          and param_diff <= param_bound and eval_equal
          and all(np.isfinite(r["loss"]) for r in plain["records"]))
    emit("ddp_world1", model=cfg["name"], card=smi, backend="nccl",
         world_size=1, steps=DDP_STEPS, crop_hw=list(crop),
         first_step_losses_bit_equal=first_equal,
         losses={tag: [{k: r[k] for k in loss_keys} for r in run["records"]]
                 for tag, run in runs.items()},
         later_loss_rel_err=later_rel, later_loss_rel_limit=DDP_LOSS_REL,
         param_max_abs_diff=param_diff, param_bound=param_bound,
         cli_step_s=cli_step_s,
         cli_steady_step_s={tag: float(np.mean(v[1:]))
                            for tag, v in cli_step_s.items()},
         run_s={tag: run["run_s"] for tag, run in runs.items()},
         step_ms_in_group=with_group_ms, step_ms_without_group=without_group_ms,
         grad_allreduce_ms=allreduce_ms, grad_bucket_mb=bucket_mb,
         launches_per_step={k: v // DDP_STEPS
                            for k, v in runs["plain"]["counts"].items()},
         eval=dict(images=DDP_EVAL_IMAGES, equal=eval_equal, **metrics),
         ok=ok, seconds=time.perf_counter() - t_phase)
    shutil.rmtree(DDP_DIR, ignore_errors=True)
    if not ok:
        raise AssertionError(
            f"world-1 data parallelism: first losses equal {first_equal}, "
            f"later loss rel {later_rel}, weights {param_diff} (bound "
            f"{param_bound}), eval metrics equal {eval_equal}")
    return {"ddp_train": runs["distributed"]["counts"],
            "ddp_eval": metrics["data_parallel_1"]["counts"]}


def phase_kernels_dinohead(dev) -> list:
    """B5's D-32 instantiations (forward with and without the LSE, the
    fused backward) at DINOhead's shapes (DINOHEAD_HM_SHAPES) against the
    plain versions, at B5's tolerances; ``multi_head_attention`` must route
    the matched D-32 views to B5."""
    randn = _randn(np.random.RandomState(SEED + 61), dev)
    rows = check_headmajor(randn, dev, shapes=DINOHEAD_HM_SHAPES,
                           phase="kernel_attention_hm_d32", d=32)
    summary = _train_summaries(rows, B5_D32_ENTRIES)
    summary[0].update(
        nolse_ms=rows[0]["fwd_nolse_ms"],
        nolse_max_abs_err=max(r["nolse_max_abs_err"] for r in rows),
        nolse_bound_ms=rows[0]["fwd_nolse_bound"]["bound_ms"])
    return summary


def dinohead_config():
    """The headline's LoRA DINOv2-L under a full-width DINOhead (channels
    256, 8 heads of 32) in ``MultiScaleEncoderDecoder``, the headline's
    test_cfg; no config file names one."""
    cfg = copy.deepcopy(headline_config())
    cfg["name"] = "lora_dinov2_l_multiscale_dinohead"
    cfg["model"] = dict(
        type="MultiScaleEncoderDecoder", backbone=cfg["model"]["backbone"],
        decode_head=dict(type="DINOhead", in_channels=[1024] * 4,
                         channels=256, num_classes=19, dropout_ratio=0.1),
        hr_crop_size=(512, 512), crop_coord_divisible=32)
    return cfg


def phase_dinohead_path(dev) -> dict:
    """``MultiScaleEncoderDecoder`` + DINOhead at full width: one
    DINOHEAD_HW image through the context-conditioned two-stage slide
    (stage 1 without context, the refine windows with it), card against
    the fp32 CPU (DRIFT_Q99, ARGMAX_AGREE); one bs2 DINOHEAD_TRAIN_HW train
    step; B5's D-32 launches on each (2 an image: the refine's self- and
    cross-attention; 2 forward and 2 backward a step) and the shapes they
    ran at, each among those phase kernel_attention_hm_d32 checked; then one
    TRAIN_CHECK_HW step bf16 against fp32 at the TRAIN_* limits."""
    t_phase = time.perf_counter()
    cfg = dinohead_config()
    tc = cfg["test_cfg"]
    kw = dict(crop=tuple(tc["crop_size"]), stride=tuple(tc["stride"]),
              lr_size=tuple(tc["lr_img_size"]), threshold=tc["threshold"],
              conf=tc["conf"])
    model = init_params(build_segmentor(
        cfg["model"], dtype=compute_dtype(cfg),
        attn_impl=compute_attn_impl(cfg)), SEED).eval()
    shapes = set()
    real_fwd = attention_mod.attention_hm_fwd

    def recording(q, *a, **k):
        if q.shape[-1] == 32:
            shapes.add(tuple(q.shape))
        return real_fwd(q, *a, **k)

    img = synthetic_images(1, DINOHEAD_HW, SEED + 63)
    attention_mod.attention_hm_fwd = recording
    try:
        kernels.reset_launch_counts()
        with torch.inference_mode():
            card = ms_slide_inference(model.lr_forward, model.hr_forward,
                                      img.to(dev), **kw)
        torch.cuda.synchronize()
        infer_counts = kernels.launch_counts()
        t0 = time.perf_counter()
        with torch.inference_mode():
            ms_slide_inference(model.lr_forward, model.hr_forward,
                               img.to(dev), **kw)
        torch.cuda.synchronize()
        infer_s = time.perf_counter() - t0
        ds = SyntheticDataset(n=2, hw=DINOHEAD_TRAIN_HW, num_classes=19,
                              seed=SEED + 65)
        state = create_train_state(model, cfg)
        kernels.reset_launch_counts()
        state, metrics = make_train_step()(state, collate([ds[0], ds[1]]),
                                           SEED)
        torch.cuda.synchronize()
        train_counts = kernels.launch_counts()
        metrics = {k: float(v) for k, v in metrics.items()}
    finally:
        attention_mod.attention_hm_fwd = real_fwd
    del state
    card = card.float().cpu()
    cpu_model = init_params(build_segmentor(
        cfg["model"], dtype=torch.float32, device="cpu",
        attn_impl=compute_attn_impl(cfg)), SEED).eval()
    t0 = time.perf_counter()
    with torch.inference_mode():
        cpu = ms_slide_inference(cpu_model.lr_forward, cpu_model.hr_forward,
                                 img, **kw)
    cpu_s = time.perf_counter() - t0
    del cpu_model, model
    torch.cuda.empty_cache()
    got = _agreement(card, cpu)
    checked = {(b_, h, nq, 32) for b_, h, nq, _ in DINOHEAD_HM_SHAPES}
    ok = (got["q99_rel_drift"] < DRIFT_Q99
          and got["argmax_agreement"] >= ARGMAX_AGREE
          and infer_counts["attention_hm_fwd_d32"] == 2
          and train_counts["attention_hm_fwd_d32"] == 2
          and train_counts["attention_hm_bwd_d32"] == 2
          and shapes <= checked
          and all(np.isfinite(list(metrics.values()))))
    emit("dinohead_path", model=cfg["name"], image_hw=list(DINOHEAD_HW),
         train_hw=list(DINOHEAD_TRAIN_HW), d32_shapes=sorted(shapes),
         infer_launches=infer_counts, train_launches=train_counts,
         infer_s=infer_s, cpu_infer_s=cpu_s, train_metrics=metrics,
         drift_limit=DRIFT_Q99, agreement_limit=ARGMAX_AGREE, ok=ok, **got,
         seconds=time.perf_counter() - t_phase)
    if not ok:
        raise AssertionError(f"DINOhead path: {got}, launches "
                             f"{infer_counts}, {train_counts}, shapes "
                             f"{shapes} (checked {checked})")
    check = copy.deepcopy(cfg)
    m = check["model"]
    m["hr_crop_size"] = TRAIN_CHECK_CROP
    m["backbone"]["Lora_config"]["lora_dropout"] = 0.0
    m["backbone"]["backbone"]["drop_path_rate"] = 0.0
    m["decode_head"]["dropout_ratio"] = 0.0
    phase_train_card_vs_cpu(dev, cfg, "dinohead", check_cfg=check)
    return {"dinohead_infer": infer_counts, "dinohead_train": train_counts}


def phase_remat(dev) -> dict:
    """The headline's bs2 1024^2 train step with ``remat=True`` against
    ``remat=False`` from one seed and batch: the losses within
    TRAIN_LOSS_REL and the LoRA gradients' cosine within TRAIN_GRAD_COS
    (the recomputation replays the forward's draws, and B5's backward sums
    dq with fp32 atomics in a changing order), the peak memory of the step
    and the time of a second one, and the recomputed blocks' launches (one
    more B3 forward and two more LayerNorms a ViT block)."""
    t_phase = time.perf_counter()
    ds = SyntheticDataset(n=2, hw=(1024, 1024), num_classes=19,
                          seed=SEED + 69)
    batch = collate([ds[0], ds[1]])
    runs = {}
    for remat in (False, True):
        cfg = copy.deepcopy(headline_config())
        cfg["model"]["backbone"]["backbone"]["remat"] = remat
        model = init_params(build_segmentor(
            cfg["model"], dtype=compute_dtype(cfg),
            attn_impl=compute_attn_impl(cfg)), SEED)
        state = create_train_state(model, cfg)
        step_fn = make_train_step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        state, metrics = step_fn(state, batch, SEED)
        torch.cuda.synchronize()
        runs[remat] = dict(
            peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
            counts=kernels.launch_counts(),
            metrics={k: float(v) for k, v in metrics.items()},
            grad=torch.cat([p.grad.float().flatten().cpu()
                            for n, p in model.named_parameters()
                            if "lora" in n]))
        t0 = time.perf_counter()
        step_fn(state, batch, SEED)
        torch.cuda.synchronize()
        runs[remat]["second_step_s"] = time.perf_counter() - t0
        depth = len(model.backbone.blocks)
        del model, state, step_fn
        torch.cuda.empty_cache()
    plain, remat = runs[False], runs[True]
    rel = {k: abs(remat["metrics"][k] - plain["metrics"][k])
           / max(abs(plain["metrics"][k]), 1e-9)
           for k in plain["metrics"] if "loss" in k}
    cos = float(F.cosine_similarity(plain["grad"].double(),
                                    remat["grad"].double(), dim=0))
    extra = {k: remat["counts"][k] - plain["counts"][k] for k in KERNEL_NAMES}
    want_extra = _counts(attention_fwd_lse=depth, layer_norm=2 * depth)
    ok = (max(rel.values()) <= TRAIN_LOSS_REL and cos >= TRAIN_GRAD_COS
          and extra == want_extra)
    emit("remat", model=headline_config()["name"], batch=2,
         image_hw=[1024, 1024], loss_rel_err=rel,
         loss_rel_limit=TRAIN_LOSS_REL, lora_grad_cosine=cos,
         cosine_limit=TRAIN_GRAD_COS,
         peak_mem_bytes={"remat": remat["peak_mem_bytes"],
                         "plain": plain["peak_mem_bytes"]},
         second_step_s={"remat": remat["second_step_s"],
                        "plain": plain["second_step_s"]},
         extra_launches=extra, ok=ok, seconds=time.perf_counter() - t_phase)
    if not ok:
        raise AssertionError(f"remat: loss rel {rel}, cosine {cos}, extra "
                             f"launches {extra} != {want_extra}")
    return {"remat": remat["counts"]}


def _debug_run(cfg_name: str, options: list, work_dir: str, source,
               target=None) -> tuple:
    """One step of the train CLI with ``schedule.debug_interval=1``; the
    panels its debug_fn made and what ``save_debug_grid`` returned."""
    cfg = load_config(cfg_name, options + [
        "schedule.debug_interval=1", "schedule.checkpoint_interval=0",
        "schedule.log_interval=1", "schedule.val_interval=0",
        "data.num_workers=1"])
    seen = []
    save = train_cli.save_debug_grid

    def recording(out_dir, step, panels, cols=4):
        path = save(out_dir, step, panels, cols)
        seen.append(dict(step=step, path=path, panels={
            k: (list(np.shape(v)), str(np.asarray(v).dtype),
                bool(np.isfinite(np.asarray(v, np.float64)).all()))
            for k, v in panels.items()}))
        return path

    train_cli.save_debug_grid = recording
    try:
        args = train_cli.parse_args([cfg_name, "--work-dir", work_dir,
                                     "--max-iters", "1"])
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        train_cli.run(cfg, args, source=source, val_sets={}, target=target)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        train_cli.save_debug_grid = save
    return seen, kernels.launch_counts(), secs


def phase_debug_grids(dev) -> dict:
    """The train CLI with ``schedule.debug_interval=1`` for one step on the
    headline and on UDA SegFormer: the panels computed on the card (every
    one finite, each key the JAX CLI's), whether a PNG was written (not
    without matplotlib)."""
    t_phase = time.perf_counter()
    root = os.path.join(REPO, "work_dirs", "chip_smoke_debug")
    shutil.rmtree(root, ignore_errors=True)
    rs = np.random.default_rng(SEED + 73)
    source = MemorySource([synthetic_sample(rs, (1024, 1024), 19)
                           for _ in range(2)], os.path.join(root, "data"))
    ms, ms_counts, ms_s = _debug_run(
        TRAIN_CLI_CONFIG, [f"data.source.data_root={source.data_root}",
                           "data.rare_class_sampling=None",
                           "data.train_pipeline.resize_scale_wh=(1024, "
                           "1024)"],
        os.path.join(root, "headline"), source)
    target = [dict(img=synthetic_sample(rs, (512, 1024), 19)["img"])
              for _ in range(2)]
    uda, uda_counts, uda_s = _debug_run(
        UDA_SEGFORMER_CONFIG, [f"data.source.data_root={source.data_root}",
                               "data.rare_class_sampling=None"],
        os.path.join(root, "uda"), source, target)
    shutil.rmtree(root, ignore_errors=True)
    want = {"headline": ["image", "gt", "lr_pred", "lr_entropy",
                         "hr_refined"],
            "uda": ["image", "gt", "pred", "entropy", "target",
                    "pseudo_label", "mix_mask", "mixed_image", "mixed_label",
                    "teacher_entropy"]}
    got = {"headline": ms, "uda": uda}
    try:
        import matplotlib  # noqa: F401
        have_mpl = True
    except ImportError:
        have_mpl = False
    ok = all(len(runs) == 1 and list(runs[0]["panels"]) == want[name]
             and all(v[2] for v in runs[0]["panels"].values())
             and (runs[0]["path"] is not None) == have_mpl
             for name, runs in got.items())
    emit("debug_grids", matplotlib=have_mpl,
         png_written={k: v[0]["path"] is not None if v else None
                      for k, v in got.items()},
         panels={k: v[0]["panels"] if v else None for k, v in got.items()},
         run_s={"headline": ms_s, "uda": uda_s}, ok=ok,
         seconds=time.perf_counter() - t_phase)
    if not ok:
        raise AssertionError(f"debug grids: {got}")
    return {"debug_headline": ms_counts, "debug_uda": uda_counts}


def main() -> None:
    t_start = time.perf_counter()
    dev_info = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    summary = phase_kernels(dev)
    train_rows, b4 = phase_kernels_train(dev)
    summary += train_rows
    ln_eva02, eva02_rows = phase_kernels_eva02(dev)
    summary += (eva02_rows + phase_kernels_sam(dev)
                + phase_kernels_compact(dev) + phase_kernels_bias_deform(dev))
    ln = summary[0]
    ln["max_abs_err"] = max([ln["max_abs_err"]]
                            + [r["max_abs_err"] for r in ln_eva02])
    ln["ms_at_2730"] = ln_eva02[0]["ms"]
    hm_bwd = next(r for r in summary if r["name"] == "attention_hm_bwd")
    hm_bwd["replaces"] += ", " + B4_REPLACES
    hm_bwd["b4_function"] = b4
    by_path = run_paths(dev, headline_config(), "dinov2", restore=True)
    by_path.update(phase_train_cli(dev, dev_info["smi"]))
    by_path.update(run_paths(dev, eva02_config(), "eva02", restore=False))
    by_path.update(run_paths(dev, sam_config(), "sam", restore=False))
    by_path.update(run_paths(dev, sam_bias_config(), "sam_bias",
                             restore=False))
    by_path.update(phase_compact_path(dev))
    by_path.update(run_m2f_paths(dev))
    by_path.update(run_rein_paths(dev))
    by_path.update(run_encdec_train(dev))
    by_path.update(run_clip_paths(dev))
    by_path.update(run_rein_clip_paths(dev))
    by_path.update(run_hrda_paths(dev))
    by_path.update(run_segformer_paths(dev))
    mit_rows, mit_ln_rows, mit_paths = run_mit_paths(dev)
    _mit_rows(summary, mit_rows, mit_ln_rows)
    by_path.update(mit_paths)
    for run in (run_dg_paths, phase_uda_cli, run_uda_m2f, run_uda_hrda):
        by_path.update(run(dev))
    by_path.update(phase_ddp_world1(dev, dev_info["smi"]))
    summary += phase_kernels_dinohead(dev)
    for run in (phase_dinohead_path, phase_remat, phase_debug_grids):
        by_path.update(run(dev))
    for row in summary:
        paths = {p: c[row["name"]] for p, c in by_path.items()}
        row["launches"] = sum(paths.values())
        row["launches_by_path"] = paths
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} never launched on a main "
                                 f"path")
    if sorted(r["name"] for r in summary) != sorted(KERNEL_NAMES):
        raise AssertionError("the kernel summary does not list every kernel")
    emit("done", seconds=time.perf_counter() - t_start)
    print(dev_info["smi"], flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
