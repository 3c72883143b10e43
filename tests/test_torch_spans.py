"""The port's profiler ranges (``vfmseg_tpu_torch/utils/profiling.py``
``span``) on the CPU: the dense per-image route exports its phases nested
and in order, the compact stream names each group's phases by its ordinal
and holds no range open while the caller runs, and with no profiler
running ``span`` opens no range and the labels are bit-equal. The Rein +
Mask2Former slide opens its backbone, pixel-decoder and mask-decoder
ranges inside ``vfmseg.predict``, an MsVFM forward opens none of them, and
the head's mask counters move only under a profiler."""

import json

import pytest
import torch

from vfmseg_tpu_torch.eval import compact, evaluator
from vfmseg_tpu_torch.models import presets
from vfmseg_tpu_torch.models.build import build_segmentor
from vfmseg_tpu_torch.utils import profiling

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(scope="module")
def tiny():
    cfg = presets.config("smoke_tiny_ms_masked")
    torch.manual_seed(0)
    model = build_segmentor(cfg["model"], device="cpu").eval()
    predict = evaluator.make_shape_aware_predict_fn(model, cfg["test_cfg"])
    img = torch.randn(1, 64, 128, 3,
                      generator=torch.Generator().manual_seed(1))
    return lambda: predict(model, img, (64, 128))


@pytest.fixture(scope="module")
def rein():
    """The tiny Rein + Mask2Former slide (3 crops of a 64 x 128 image)."""
    cfg = presets.config("smoke_tiny_rein_m2f")
    torch.manual_seed(0)
    model = build_segmentor(cfg["model"], device="cpu").eval()
    predict = evaluator.make_shape_aware_predict_fn(model, cfg["test_cfg"])
    img = torch.randn(1, 64, 128, 3,
                      generator=torch.Generator().manual_seed(3))
    return model, lambda: predict(model, img, (64, 128))


M2F_PHASES = ("vfmseg.backbone", "vfmseg.pixel_decoder",
              "vfmseg.mask_decoder")


def _toy_engine():
    """A compact engine over toy functions: stage 1 is confident (class 1
    lifted by 100) where the image is positive and undecided elsewhere."""
    w = torch.randn(3, 4, generator=torch.Generator().manual_seed(2))

    def lr_fn(variables, x):
        out = torch.zeros(x.shape[:3] + (4,))
        out[..., 1] = 100.0 * (x[..., 0] > 0)
        return out

    def hr_fn(variables, crops, ctx):
        return crops @ w + ctx * 0.1

    return compact.CompactMsSlide(lr_fn, hr_fn, crop=(32, 32),
                                  stride=(16, 16), lr_size=(32, 32))


# two groups of two: the first all confident (nothing refined), the second
# undecided everywhere
IMAGES = [torch.full((64, 64, 3), v) for v in (1.0, 2.0, -1.0, -2.0)]


def _stream(caller):
    """The toy engine's stream over ``IMAGES`` (groups of 2, depth 1), the
    caller's handling of each output inside ``caller()``."""
    outs = []
    for out in _toy_engine().stream(None, IMAGES, group=2, depth=1):
        with caller():
            outs.append(out.clone())
    return outs


def _ranges(prof, tmp_path):
    """(start, end, name) of the exported trace's ranges, in start
    order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in events if e.get("ph") == "X")


def _named(ranges, prefix):
    return [r for r in ranges if r[2].startswith(prefix)]


def _holds(outer, inner):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_dense_predict_exports_its_phases_nested(tiny, tmp_path):
    """One dense ``predict``: ``vfmseg.predict`` holds ``stage1`` (which
    holds ``lr_forward``) and then ``refine`` (which holds
    ``hr_forward``), each once."""
    with torch.profiler.profile(activities=CPU) as prof:
        tiny()
    got = _named(_ranges(prof, tmp_path), "vfmseg.")
    assert [n for _, _, n in got] == [
        "vfmseg.predict", "vfmseg.stage1", "vfmseg.lr_forward",
        "vfmseg.refine", "vfmseg.hr_forward"]
    predict, stage1, lr, refine, hr = got
    assert _holds(predict, stage1) and _holds(stage1, lr)
    assert _holds(predict, refine) and _holds(refine, hr)
    assert stage1[1] <= refine[0]


def test_stream_ranges_carry_the_group_and_no_yield(tmp_path):
    """Each group's stage 1 is ``vfmseg.stage1#g``; only a group that
    refines has ``vfmseg.refine#g``; no range of the stream holds the
    caller's handling of an output."""
    with torch.profiler.profile(activities=CPU) as prof:
        _stream(lambda: torch.profiler.record_function("caller"))
    ranges = _ranges(prof, tmp_path)
    ours = _named(ranges, "vfmseg.")
    assert [n for _, _, n in ours] == ["vfmseg.stage1#0", "vfmseg.stage1#1",
                                       "vfmseg.refine#1"]
    callers = _named(ranges, "caller")
    assert len(callers) == len(IMAGES)
    assert not any(_holds(r, c) for r in ours for c in callers)


@pytest.mark.parametrize("route", ["dense", "stream"])
def test_span_opens_nothing_without_a_profiler(tiny, route, monkeypatch):
    """With no profiler running, ``span`` hands out its shared no-op context
    and never makes a range (the range's type is patched to raise); the
    labels equal, bit for bit, those made under the profiler."""
    run = tiny if route == "dense" else (
        lambda: _stream(lambda: profiling.span("caller")))
    with torch.profiler.profile(activities=CPU):
        want = run()

    def refuse(name):
        raise AssertionError(f"range {name!r} opened with no profiler")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    assert profiling.span("a") is profiling.span("b")
    got = run()
    for g, w in zip(got, want) if route == "stream" else [(got, want)]:
        assert torch.equal(g, w)


def test_rein_slide_opens_its_phases_inside_predict(rein, tmp_path):
    """One slide ``predict``: ``vfmseg.predict`` holds the backbone, the
    pixel decoder and the mask decoder in that order (the head's decoder,
    then the semantic inference, both ``vfmseg.mask_decoder``), and the
    head counted its masks: 3 decoder layers over 3 crops of 10 queries."""
    model, run = rein
    head = model.decode_head
    rows, pairs = head.stat_rows, head.stat_pairs
    with torch.profiler.profile(activities=CPU) as prof:
        run()
    got = _named(_ranges(prof, tmp_path), "vfmseg.")
    assert [n for _, _, n in got] == [
        "vfmseg.predict", "vfmseg.backbone", "vfmseg.pixel_decoder",
        "vfmseg.mask_decoder", "vfmseg.mask_decoder"]
    predict, backbone, pixel, decoder, semantic = got
    assert all(_holds(predict, r) for r in got[1:])
    assert backbone[1] <= pixel[0] and pixel[1] <= decoder[0]
    assert decoder[1] <= semantic[0]
    assert head.stat_rows - rows == 3 * 3 * 10
    # the levels at 2 x 2, 4 x 4 and 8 x 8 keys
    assert head.stat_pairs - pairs == 3 * 10 * (4 + 16 + 64)
    assert 0 <= int(head.stat_hidden_pairs) <= head.stat_pairs
    assert 0 <= int(head.stat_reset_rows) <= head.stat_rows


def test_msvfm_forward_opens_no_m2f_range(tiny, tmp_path):
    with torch.profiler.profile(activities=CPU) as prof:
        tiny()
    names = {n for _, _, n in _ranges(prof, tmp_path)}
    assert not names & set(M2F_PHASES)


def test_mask_counters_untouched_without_a_profiler(rein):
    """With no profiler running the head counts nothing: the counters keep
    their values (their tensors are the same objects) and the labels equal
    those made under the profiler."""
    model, run = rein
    head = model.decode_head
    with torch.profiler.profile(activities=CPU):
        want = run()
    before = (head.stat_hidden_pairs, head.stat_reset_rows, head.stat_pairs,
              head.stat_rows)
    got = run()
    assert before[0] is not None
    after = (head.stat_hidden_pairs, head.stat_reset_rows, head.stat_pairs,
             head.stat_rows)
    assert all(a is b for a, b in zip(after[:2], before[:2]))
    assert after[2:] == before[2:]
    assert torch.equal(got, want)
