"""The Rein + Mask2Former slide cell on the CPU at toy sizes: the loop and
its result line, the traced line's per-layer metrics, the check failing
under planted faults and under the control, the program's scores and
masks agreeing with the float32 reference's, the counters covering one
traced span, and the reckoned work against PyTorch's FLOP counter and
against hand-worked shapes."""

import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from cardbench import (
    counters,
    counters_rein_m2f,
    faults_rein_m2f,
    harness,
    limits,
    program,
    spec,
    weights_rein_m2f,
)
from cardbench_toys import toy

SEED = 2 ** 31 + 12345
CELL = "rein_m2f.eval_slide"


def _cell() -> spec.Cell:
    real = spec.load_cell(CELL)
    return spec.Cell(name="toy", chips=1, config=toy("toy_rein_m2f"),
                     mix=toy("toy_per_image_slide"),
                     end_to_end=real.end_to_end, per_layer=real.per_layer)


def _run(traced=False, loop=None):
    return harness.run(_cell(), SEED, 3.0, traced, time.perf_counter(),
                       "cpu", loop=loop)


def test_the_cell_reports_the_dense_metrics_and_ten_of_its_own():
    c = spec.load_cell(CELL)
    assert c.chips == 1 and c.mix["loop"] == "per_image_slide"
    assert {m["name"] for m in c.end_to_end} == {
        "dense_images_per_s", "image_latency_p95_ms", "setup_s"}
    assert {m["name"] for m in c.per_layer} == {
        "backbone_ms.slide", "pixel_decoder_ms.slide",
        "mask_decoder_ms.slide", "predict_ms.slide", "deform_roofline.slide",
        "mfu.slide", "idle.slide", "peak_mem_gib.slide", "m2f.masked_share",
        "attention_roofline.slide"}


def test_toy_cell_runs_and_is_correct():
    line, tail = _run()
    line.pop("_frames")
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0, (
        line["checks"], tail)
    assert set(line["metrics"]) == {"dense_images_per_s",
                                    "image_latency_p95_ms", "setup_s"}


def test_traced_line_reads_the_counter_and_the_work():
    line, _ = _run(traced=True)
    m = line["metrics"]
    assert 0 < m["m2f.masked_share"]["value"] < 100
    assert 0 < m["mfu.slide"]["value"] < 100
    # no kernel ran on the CPU: the device readers read nothing, not 0
    for name in ("backbone_ms.slide", "pixel_decoder_ms.slide",
                 "mask_decoder_ms.slide", "predict_ms.slide",
                 "deform_roofline.slide", "peak_mem_gib.slide",
                 "attention_roofline.slide"):
        assert name not in m


@pytest.mark.parametrize("fault", sorted(faults_rein_m2f.FAULTS))
def test_planted_faults_read_not_correct(fault):
    line, _ = _run(loop=faults_rein_m2f.FAULTS[fault])
    assert not line["correct"]
    assert line["failed"] > 0
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_control_reads_not_correct_and_limits_read_both():
    got = limits.readings(_cell(), SEED, "cpu")
    lim = _cell().config["check"]["inference"]
    assert all(got["program"][k] <= lim[k] for k in lim)
    assert any(got["control"][k] > lim[k] for k in lim), got["control"]
    # the reference ran with TF32 off
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_float32_scores_and_masks_agree_with_the_reference():
    """The toy program in float32: every decoder mask equal to the
    reference's, the scores equal to rounding, the window's labels their
    argmax; the readings name each frame's classes."""
    got = limits.readings(_cell(), SEED, "cpu")
    for f in got["frames"]:
        assert f["mask_flips"] == 0.0
        assert f["window_mismatch"] == 0.0
        assert f["score_err_l2"] < 1e-5
        assert f["classes"] >= 1
    assert "mask_flips" not in got["control_frames"][0]


def test_the_counters_cover_the_traced_span_alone():
    """A second traced span in one process counts its own images: the
    loop zeroes the head's counters as the span begins."""
    lp = harness.loop_class("per_image_slide")(_cell(), SEED, "cpu")
    lp.setup()
    counts = []
    for _ in range(2):
        with torch.profiler.profile():
            lp.span()
        counts.append((int(lp.head.stat_hidden_pairs), lp.head.stat_pairs))
    assert counts[0] == counts[1] and counts[0][1] > 0


def test_flops_match_the_flop_counter():
    """The program's plain CPU path over 3 crops, counted by PyTorch: the
    reckoned work plus what it leaves out on purpose, the deformable
    weighted sum (an einsum over the points, elementwise work) and the
    program's second product of Rein's tokens (once in each layer's update,
    once for the queries)."""
    cfg = toy("toy_rein_m2f")
    model = program.build(cfg, weights_rein_m2f.make(cfg["model"], 3, "cpu"),
                          "cpu")
    crops = torch.randn(3, *cfg["test_cfg"]["crop_size"], 3)
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        model(crops)
    s = counters_rein_m2f._sizes(cfg)
    kv = sum(h * w for h, w in s["levels"])
    weighted_sum = 2 * 3 * 6 * 3 * counters_rein_m2f.POINTS * kv * s["c"]
    tokens = 2 * s["depth"] * s["t"] * s["r"] * s["e"]
    # the program applies querys2feat to each crop's copy of the queries
    per_crop_query = 2 * 2 * s["t"] * s["q"] * s["c"]
    want = (3 * counters_rein_m2f.crop_flops(cfg)
            + counters_rein_m2f.call_flops(cfg)
            + weighted_sum + tokens + per_crop_query)
    assert fc.get_total_flops() == want


def test_deform_bytes_at_the_eval_shape():
    """B8 at the pyramid's 64^2 level over 18 crops: value [144, 64, 64,
    32], 21504 samples of x and y, [144, 21504, 32] out, bf16: 0.0778 ms
    at 3.35 TB/s a call, PERF.md's bound."""
    cfg = spec.load_cell(CELL).config
    by_level = counters_rein_m2f.deform_bytes_by_level(cfg, (1024, 2048))
    call = (144 * 64 * 64 * 32 * 2 + 2 * 144 * 21504 * 4
            + 144 * 21504 * 32 * 2)
    assert by_level[-1] == 6 * call
    assert call / counters.HBM_BYTES_PER_S == pytest.approx(7.78e-5,
                                                            rel=2e-3)
    assert counters_rein_m2f.crops(cfg, (1024, 2048)) == 18


def test_the_reference_loads_nothing_of_the_program_nor_jax():
    from test_cardbench_imports import FORBIDDEN, _loaded

    top = _loaded("import cardbench.reference.rein_m2f, "
                  "cardbench.check_slide, cardbench.weights_rein_m2f, "
                  "cardbench.counters_rein_m2f")
    assert not top & (FORBIDDEN | {"vfmseg_tpu_torch"})
    top = _loaded("from cardbench import harness, faults_rein_m2f\n"
                  "harness.loop_class('per_image_slide')")
    assert "vfmseg_tpu_torch" in top and not top & FORBIDDEN
