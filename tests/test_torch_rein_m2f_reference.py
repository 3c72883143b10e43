"""The port's Rein DINOv2 + Mask2Former (``dg_rein_dinov2_mask2former``)
against the benchmark's plain reference (``cardbench/reference/rein_m2f.py``)
on the CPU, in float32, on one seeded state (``cardbench/weights_rein_m2f``)
loaded into both with ``strict=True``.

Toy sizes (``cardbench/tests/toy/toy_rein_m2f.json``): E 64, 4 blocks of 4
heads, 16 Rein tokens at rank 16 (which, linked to the queries, make the
head's 16 queries), feat channels 64 (GroupNorm's 32 groups), the pixel
decoder's 6 layers as built, 2 decoder layers; a 128 x 256 frame, crops of
64 at stride 43 (18 crops, as a 1024 x 2048 frame has at 512 / 341).

Tolerances: both sides compute in float32 from the same weights, in
different orders (the reference's einsums and ``grid_sample`` against the
program's kernels' plain twins, the masks' resize before or after the
channel product), so they agree to float32 rounding through 4 blocks, 6
encoder and 2 decoder layers: 1e-5 of the largest magnitude, ten times the
widest reading (2.5e-6). A label may differ only where the reference's top
two scores lie within 1e-4 of each other (rounding's reach at that
tolerance).
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from cardbench import program, weights_rein_m2f  # noqa: E402
from cardbench.reference import rein_m2f  # noqa: E402
from cardbench.tests.cardbench_toys import toy  # noqa: E402
from vfmseg_tpu_torch.eval.evaluator import (  # noqa: E402
    make_logits_fn,
    make_shape_aware_predict_fn,
)
from vfmseg_tpu_torch.models.heads import mask2former as m2f  # noqa: E402

TOL = 1e-5
PR = rein_m2f.Products()


@pytest.fixture(scope="module")
def pair():
    cfg = toy("toy_rein_m2f")
    sd = weights_rein_m2f.make(cfg["model"], 5, "cpu")
    port = program.build(cfg, sd, "cpu")
    ref = rein_m2f.build(cfg["model"], "cpu")
    ref.load_state_dict(sd, strict=True)
    g = torch.Generator().manual_seed(0)
    crops = torch.randn(3, *cfg["test_cfg"]["crop_size"], 3, generator=g)
    with torch.inference_mode():
        feats = port.features(crops)
        ref_feats = ref.backbone(crops, PR)
    return cfg, port, ref, crops, feats, ref_feats


def _rel(got, want):
    assert got.shape == want.shape
    return float((got - want).abs().max() / want.abs().max())


def test_one_seeded_state_loads_strictly_into_both():
    cfg = toy("toy_rein_m2f")
    sd = weights_rein_m2f.make(cfg["model"], 1, "cpu")
    port = program.build(cfg, sd, "cpu")
    ref = rein_m2f.build(cfg["model"], "meta")
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    # the deformable layers' query projections and Rein's tokens are drawn
    # non-zero, so every sample depends on its query
    for k, v in sd.items():
        if k.endswith(("sampling_offsets.weight", "attention_weights.weight",
                       "learnable_tokens_a", "learnable_tokens_b")):
            assert v.count_nonzero() == v.numel(), k


def test_rein_features_and_queries(pair):
    _, _, _, _, (feats, queries), (ref_feats, ref_queries) = pair
    assert [f.shape[1:3] for f in feats] == [(16, 16), (8, 8), (4, 4),
                                             (2, 2)]
    for got, want in zip(feats, ref_feats):
        assert _rel(got, want) < TOL
    assert _rel(queries, ref_queries) < TOL


def test_pixel_decoder_outputs(pair):
    _, port, ref, _, (feats, _), (ref_feats, _) = pair
    with torch.inference_mode():
        mask, memories = port.decode_head.pixel_decoder(feats)
        ref_mask, ref_memories = ref.decode_head.pixel_decoder(ref_feats, PR)
    assert _rel(mask, ref_mask) < TOL
    assert len(memories) == 3
    for got, want in zip(memories, ref_memories):
        assert _rel(got, want) < TOL


def test_head_semantic_logits(pair):
    _, port, ref, crops, _, (ref_feats, ref_queries) = pair
    with torch.inference_mode():
        got = port(crops)
        want = ref.decode_head(ref_feats, ref_queries, PR)
    assert got.shape == (3, 16, 16, 19)
    assert _rel(got, want) < TOL


def test_slide_predictor_logits_and_labels(pair):
    cfg, port, ref, _, _, _ = pair
    t = cfg["test_cfg"]
    img = torch.randn(1, 128, 256, 3, generator=torch.Generator()
                      .manual_seed(1))
    with torch.inference_mode():
        got = make_logits_fn(port, t, "slide")(port, img)[0]
        labels = make_shape_aware_predict_fn(port, t)(port, img,
                                                      (128, 256))[0]
    want = ref.slide_logits(img, t, PR)
    assert _rel(got, want) < TOL
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-4
    assert clear.float().mean() > 0.99
    assert torch.equal(labels[clear].long(), want.argmax(-1)[clear])


def test_mask_rule_and_a_row_that_hides_every_key():
    """``sigmoid < 0.5`` hides a pair; a row hiding every key attends to
    all of them, on both sides, and the program flags the row it reset."""
    g = torch.Generator().manual_seed(2)
    logits = torch.randn(2, 5, 4, 6, generator=g)
    logits[0, 3] = -1.0 - torch.rand(4, 6, generator=g)   # hides every key
    logits[1, 0] = 1.0 + torch.rand(4, 6, generator=g)    # hides none
    got, reset = m2f._attention_mask(logits)
    want = rein_m2f.attention_mask(logits)
    assert torch.equal(got, want)
    assert not got[0, 3].any() and not got[1, 0].any()
    assert reset[..., 0].nonzero().tolist() == [[0, 3]]
    plain = torch.sigmoid(logits) < 0.5
    others = torch.ones(2, 5, dtype=torch.bool)
    others[0, 3] = False
    assert torch.equal(got[others], plain.flatten(2)[others])
