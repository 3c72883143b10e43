"""The port's compact gated engine and its window blend (B9) against the JAX
package's, on the CPU.

B9's plain version is held to the Pallas kernel itself (interpret mode) in
fp32 and to the JAX engine's XLA blend chain in bf16, bit for bit. The
engine mirrors tests/test_compact.py on both sides with the same toy
lr/hr functions and numpy inputs, and a headline-structured MsVFM at mid
scale runs through both compact engines from one weight set. fp32 unless a
test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_models import jax_model_and_variables, port_model, toy_config
from test_torch_slice import _midpoint_gap
from vfmseg_tpu.eval import compact as jax_compact
from vfmseg_tpu.eval import slide as jax_slide
from vfmseg_tpu.models.segmentors.ms_vfm import MsVFMSegmentor as JaxMsVFM
from vfmseg_tpu.ops import window_blend as jax_blend
from vfmseg_tpu_torch import kernels
from vfmseg_tpu_torch.eval import compact
from vfmseg_tpu_torch.eval.evaluator import make_compact_ms_slide
from vfmseg_tpu_torch.eval.slide import compute_slide_grid, ms_slide_inference
from vfmseg_tpu_torch.ops.window_blend import (
    blend_windows,
    blend_windows_cuda,
    blend_windows_plain,
)

GEOM = dict(crop=(32, 32), stride=(16, 16), lr_size=(32, 32),
            threshold=0.968, conf=0.8)


def _np(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _windows(seed, b, boxes, k, pads):
    """k window origins: k - pads distinct (image, box) picks in ascending
    window id, then ``pads`` copies of the last window (the engine's pad
    rows)."""
    n = len(boxes) * b
    ids = sorted(np.random.RandomState(seed).choice(n, k - pads,
                                                    replace=False).tolist())
    ids += [n - 1] * pads
    img_i = np.asarray([i % b for i in ids], np.int32)
    ys = np.asarray([boxes[i // b][0] for i in ids], np.int32)
    xs = np.asarray([boxes[i // b][1] for i in ids], np.int32)
    return img_i, ys, xs


# ---------------------------------------------------------------- B9 ----

def test_blend_plain_matches_pallas_kernel_fp32():
    """fp32, bit-identical to ``blend_windows`` under the TPU interpreter, at
    a geometry its ``supports`` takes (row origins multiples of 8): 5
    overlapping 32x32 windows over [1, 64, 128, 19]."""
    boxes = [(0, 0), (8, 16), (16, 40), (32, 96), (24, 30)]
    assert jax_blend.supports(boxes, (32, 32), (64, 128), 19)
    base = _np(0, (1, 64, 128, 19))
    delta = _np(1, (5, 32, 32, 19))
    img_i = np.zeros(5, np.int32)
    ys = np.asarray([y for y, _ in boxes], np.int32)
    xs = np.asarray([x for _, x in boxes], np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_blend.blend_windows(
            jnp.asarray(base), jnp.asarray(delta), jnp.asarray(img_i),
            jnp.asarray(ys), jnp.asarray(xs)))
    got = blend_windows_plain(torch.from_numpy(base.copy()),
                              torch.from_numpy(delta), torch.from_numpy(img_i),
                              torch.from_numpy(ys), torch.from_numpy(xs))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, base)


def _jax_chain(base, delta, img_i, ys, xs):
    """The JAX engine's default blend (compact.py:293-301): a fori_loop of
    dynamic-slice adds in the base's dtype."""
    ch, cw = delta.shape[1:3]

    def blend(i, out):
        region = jax.lax.dynamic_slice(out, (img_i[i], ys[i], xs[i], 0),
                                       (1, ch, cw, out.shape[3]))
        return jax.lax.dynamic_update_slice(
            out, region + delta[i][None], (img_i[i], ys[i], xs[i], 0))

    return jax.jit(lambda b: jax.lax.fori_loop(0, delta.shape[0], blend, b))(
        base)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_blend_plain_matches_jax_chain(dtype):
    """bf16 (the base under a bf16 model) and fp32, bit-identical to the JAX
    engine's XLA chain: two images, 12 overlapping windows of the slide grid
    plus 3 zero pad rows at the last window's origin."""
    boxes = compute_slide_grid((48, 80), (32, 32), (16, 16))
    img_i, ys, xs = _windows(2, 2, boxes, 15, 3)
    delta = _np(4, (15, 32, 32, 19))
    delta[-3:] = 0.0
    base = _np(3, (2, 48, 80, 19))
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    # read back before the plain blend runs: it adds in place, and in fp32
    # the torch base shares ``base``'s memory, which JAX may still be reading
    want = np.asarray(_jax_chain(
        jnp.asarray(base, jdt), jnp.asarray(delta, jdt), jnp.asarray(img_i),
        jnp.asarray(ys), jnp.asarray(xs)).astype(jnp.float32))
    got = blend_windows_plain(
        torch.from_numpy(base).to(tdt), torch.from_numpy(delta).to(tdt),
        torch.from_numpy(img_i), torch.from_numpy(ys), torch.from_numpy(xs))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_blend_routes_by_device():
    """CPU tensors take the plain loop and launch nothing; the kernel's
    wrapper refuses them."""
    base = torch.zeros(1, 8, 8, 3)
    delta = torch.ones(2, 4, 4, 3)
    idx = torch.zeros(2, dtype=torch.int32)
    ys = torch.tensor([0, 2], dtype=torch.int32)
    before = kernels.launch_counts()
    out = blend_windows(base, delta, idx, ys, ys)
    assert kernels.launch_counts() == before
    assert float(out.sum()) == 2 * 16 * 3
    assert float(out[0, 2:4, 2:4].max()) == 2.0
    with pytest.raises(ValueError, match="CUDA"):
        blend_windows_cuda(base, delta, idx, ys, ys)


# ---------------------------------------------------- gate and buckets ----

def test_window_confidence_is_exact():
    """The integral-image box means equal the JAX function's bit for bit."""
    full = _np(5, (2, 96, 160, 7), scale=3.0)
    boxes = compute_slide_grid((96, 160), (64, 64), (32, 48))
    want = np.asarray(jax_compact.window_confidence(
        jnp.asarray(full), boxes, (64, 64), 0.6))
    got = compact.window_confidence(torch.from_numpy(full), boxes, (64, 64),
                                    0.6).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < (want > 0).sum() and (want < 1).any()


def test_buckets_equal_jax():
    assert compact.DEFAULT_BUCKETS == jax_compact.DEFAULT_BUCKETS
    for n in range(0, 400):
        for buckets in (compact.DEFAULT_BUCKETS, (0, 2)):
            assert compact._bucket(n, buckets) == jax_compact._bucket(
                n, buckets)


# ------------------------------------------------------------ the engine ----

W_LR = _np(6, (3, 4))


def _jax_fns():
    w = jnp.asarray(W_LR)

    def lr_fn(variables, x):
        del variables
        logits = x @ w
        top = jax.lax.broadcasted_iota(jnp.int32, logits.shape, 1) < (
            logits.shape[1] // 2)
        return logits + jnp.where(top, 50.0, 0.0) * jax.nn.one_hot(2, 4)

    def hr_fn(variables, crops, ctx):
        del variables
        return crops @ w * 2.0 + ctx * 0.1

    return lr_fn, hr_fn


def _fns():
    """The toy functions of tests/test_compact.py: confident in the top half
    (class 2 lifted by 50), a linear refine head."""
    w = torch.from_numpy(W_LR)

    def lr_fn(variables, x):
        del variables
        logits = x @ w
        top = torch.arange(logits.shape[1])[None, :, None] < (
            logits.shape[1] // 2)
        return logits + torch.where(top, 50.0, 0.0)[..., None] * \
            torch.nn.functional.one_hot(torch.tensor(2), 4)

    def hr_fn(variables, crops, ctx):
        del variables
        return crops @ w * 2.0 + ctx * 0.1

    return lr_fn, hr_fn


def _dense(img):
    lr_fn, hr_fn = _fns()
    return ms_slide_inference(lambda x: lr_fn(None, x),
                              lambda c, t: hr_fn(None, c, t), img, **GEOM)


def test_compact_call_matches_jax():
    """``__call__`` against the JAX engine at 1e-5, the same windows
    refined."""
    img = _np(7, (1, 64, 64, 3))
    want, want_n = jax_compact.CompactMsSlide(*_jax_fns(), **GEOM)(
        None, jnp.asarray(img))
    got, n = compact.CompactMsSlide(*_fns(), **GEOM)(None,
                                                     torch.from_numpy(img))
    assert n == want_n and 0 < n < 9
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_compact_matches_dense():
    img = torch.from_numpy(_np(8, (1, 64, 64, 3)))
    out, n = compact.CompactMsSlide(*_fns(), **GEOM)(None, img)
    assert 0 < n < 9
    torch.testing.assert_close(out, _dense(img), atol=1e-5, rtol=1e-5)


def test_stream_matches_dense_per_image():
    """Grouped stage 1 and the pipelined gate give each image's dense
    logits, in order, across a non-full tail group."""
    images = [torch.from_numpy(_np(10 + i, (64, 64, 3))) for i in range(5)]
    engine = compact.CompactMsSlide(*_fns(), **GEOM)
    outs = list(engine.stream(None, images, group=2, depth=2))
    assert len(outs) == 5
    for im, out in zip(images, outs):
        torch.testing.assert_close(out, _dense(im[None])[0], atol=1e-5,
                                   rtol=1e-5)


def test_bucket_overflow_still_refines_everything():
    """More needed windows than the largest bucket are all refined."""
    img = torch.from_numpy(_np(4, (2, 64, 64, 3)))
    out, n = compact.CompactMsSlide(*_fns(), buckets=(0, 2), **GEOM)(None,
                                                                     img)
    assert n > 2
    torch.testing.assert_close(out, _dense(img), atol=1e-5, rtol=1e-5)


def test_all_confident_refines_nothing():
    def lr_fn(variables, x):
        out = torch.zeros(x.shape[:3] + (4,))
        out[..., 1] = 100.0
        return out

    def hr_fn(variables, crops, ctx):
        raise AssertionError("nothing may be refined")

    engine = compact.CompactMsSlide(lr_fn, hr_fn, crop=(32, 32),
                                    stride=(16, 16), lr_size=(32, 32))
    out, n = engine(None, torch.from_numpy(_np(2, (1, 64, 64, 3))))
    assert n == 0 and tuple(out.shape) == (1, 64, 64, 4)
    assert engine.stat_refine_rows == 0


def test_gate_stat_counters():
    """Windows seen and refined tally per call and per stream, and the
    refine rows count the bucket's padding."""
    img = torch.from_numpy(_np(1, (2, 64, 64, 3)))
    engine = compact.CompactMsSlide(*_fns(), **GEOM)
    _out, n = engine(None, img)
    assert engine.stat_windows == 2 * 9
    assert engine.stat_refined == n > 0
    assert engine.stat_refine_rows == compact._bucket(n, engine.buckets)
    engine.reset_stats()
    assert (engine.stat_windows, engine.stat_refined,
            engine.stat_refine_rows) == (0, 0, 0)
    list(engine.stream(None, [img[0], img[1]], group=2))
    assert (engine.stat_windows, engine.stat_refined) == (18, n)


@pytest.mark.parametrize("forced", [2, 16])
def test_forced_bucket_matches_jax(forced):
    """The zero-readback mode: every group refines exactly ``forced``
    windows chosen on the device (fewer than needed at 2, so not the dense
    result), equal to the JAX engine's outputs and counters."""
    images = [_np(20 + i, (64, 64, 3)) for i in range(3)]
    jeng = jax_compact.CompactMsSlide(*_jax_fns(), forced_bucket=forced,
                                      **GEOM)
    want = [np.asarray(o) for o in jeng.stream(
        None, [jnp.asarray(im) for im in images], group=2)]
    eng = compact.CompactMsSlide(*_fns(), forced_bucket=forced, **GEOM)
    got = list(eng.stream(None, [torch.from_numpy(im) for im in images],
                          group=2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)
    assert (eng.stat_windows, eng.stat_refined) == (jeng.stat_windows,
                                                    jeng.stat_refined)
    assert eng.stat_refine_rows == 2 * forced


def test_bf16_model_blends_in_fp32():
    """A divergence from the JAX engine, which blends in the model's dtype
    (compact.py:218-301): under a bf16 model with stage-1 logits of
    magnitude ~100, its bf16 deltas and adds move the result by up to ~1
    from the dense path's fp32 overlap average. The port blends into an
    fp32 copy and returns fp32 logits, within fp32 rounding of its dense
    path (ROADMAP §C)."""
    lr32, hr32 = _fns()
    jlr32, jhr32 = _jax_fns()

    def lr_fn(v, x):
        return (lr32(v, x) * 4.0).to(torch.bfloat16)

    def hr_fn(v, c, t):
        return hr32(v, c, t.float()).to(torch.bfloat16)

    def jlr_fn(v, x):
        return (jlr32(v, x) * 4.0).astype(jnp.bfloat16)

    def jhr_fn(v, c, t):
        return jhr32(v, c, t.astype(jnp.float32)).astype(jnp.bfloat16)

    img = _np(15, (1, 64, 64, 3))
    dense = ms_slide_inference(lambda x: lr_fn(None, x),
                               lambda c, t: hr_fn(None, c, t),
                               torch.from_numpy(img), **GEOM)
    got, n = compact.CompactMsSlide(lr_fn, hr_fn, **GEOM)(
        None, torch.from_numpy(img))
    want, jn = jax_compact.CompactMsSlide(jlr_fn, jhr_fn, **GEOM)(
        None, jnp.asarray(img))
    assert 0 < n == jn < 9 and float(dense.abs().max()) > 100
    assert got.dtype == torch.float32
    port_err = float((got - dense).abs().max())
    jax_err = float(np.abs(np.asarray(want, np.float32)
                           - dense.numpy()).max())
    assert port_err <= 1e-4 * float(dense.abs().max()), port_err
    assert jax_err > 0.1, jax_err


# ------------------------------------------- mid-scale MsVFM, both sides ----

MID = dict(crop=(128, 128), stride=(96, 96), lr_size=(128, 256))


@pytest.fixture(scope="module")
def midscale():
    """The headline structure (toy widths, 4 blocks) on a 256x512 image:
    threshold and conf picked from the JAX stage 1 so that both gate
    outcomes occur with margin."""
    cfg = toy_config()
    jmodel, variables = jax_model_and_variables(cfg, seed=2)
    model = port_model(cfg, variables)
    img = _np(9, (1, 256, 512, 3), scale=0.6)
    lr = jax_slide.resize(jnp.asarray(img), size=MID["lr_size"],
                          method="bilinear")
    stage1 = jax_slide.resize(jax.jit(lambda v, x: jmodel.apply(
        v, x, method=JaxMsVFM.lr_forward))(variables, lr), size=(256, 512),
        method="bilinear")
    pmax = np.asarray(jax.nn.softmax(stage1, axis=-1).max(-1)).ravel()
    threshold = _midpoint_gap(pmax, 0.4, 0.6)
    boxes = jax_slide.compute_slide_grid((256, 512), MID["crop"],
                                         MID["stride"])
    conf = _midpoint_gap(np.asarray(jax_compact.window_confidence(
        stage1, boxes, MID["crop"], threshold)), 0.3, 0.7)
    return dict(jmodel=jmodel, variables=variables, model=model, img=img,
                test_cfg=dict(mode="ms_slide_inference", gate="compact",
                              threshold=threshold, conf=conf,
                              crop_size=MID["crop"], stride=MID["stride"],
                              lr_img_size=MID["lr_size"]))


def test_msvfm_midscale_compact_matches_jax(midscale):
    """Image -> compact gated engine -> logits on both sides from one weight
    set: identical window confidences and refine count, logits within
    1e-3, argmax agreement >= 99.9% (ROADMAP A5; mirrors
    test_parity_fullscale.py::test_msvfm_midscale_e2e_argmax_agreement)."""
    s = midscale
    jm = s["jmodel"]
    jeng = jax_compact.CompactMsSlide(
        lambda v, x: jm.apply(v, x, method=JaxMsVFM.lr_forward),
        lambda v, c, t: jm.apply(v, c, t, False, False,
                                 method=JaxMsVFM.hr_forward),
        crop=MID["crop"], stride=MID["stride"], lr_size=MID["lr_size"],
        threshold=s["test_cfg"]["threshold"], conf=s["test_cfg"]["conf"])
    want, want_n = jeng(s["variables"], jnp.asarray(s["img"]))
    _full, want_conf = jeng._stage1(s["variables"], jnp.asarray(s["img"]),
                                    (256, 512))

    engine = make_compact_ms_slide(s["model"], s["test_cfg"])
    img = torch.from_numpy(s["img"])
    with torch.inference_mode():
        _f, conf = engine._stage1_impl(s["model"], img, (256, 512))
    got, n = engine(s["model"], img)
    n_windows = len(compute_slide_grid((256, 512), MID["crop"],
                                       MID["stride"]))
    assert 0 < want_n < n_windows, "both gate outcomes occur"
    np.testing.assert_array_equal(conf.numpy() < s["test_cfg"]["conf"],
                                  np.asarray(want_conf)
                                  < s["test_cfg"]["conf"])
    assert n == want_n
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=0)
    agree = float((got.numpy().argmax(-1)
                   == np.asarray(want).argmax(-1)).mean())
    assert agree >= 0.999, agree
