"""The program's ranges in a trace (``cardbench/spans.py``) and the ten
readers of the phase metrics, on a hand-written event list whose every
number is worked out by hand; the same list pins what ``Trace`` computes.
Then the toy cells: the program's ranges reach the traced span on the CPU,
where nothing runs on a device and the phase metrics read nothing."""

import pytest

from cardbench import harness, spans, spec
from cardbench import trace as trace_mod
from cardbench_toys import cell

SEED = 2 ** 31 + 12345


def _x(name, cat, ts, end):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=end - ts)


# one profiled span, 0-1000 us: a dense image's ranges, their launches
# (one a runtime call holding its own driver call, one a driver launch),
# and the device ops they put on the stream (two kernels overlapping)
EVENTS = [
    _x(trace_mod.SPAN, "user_annotation", 0, 1000),
    _x("vfmseg.predict", "cpu_op", 10, 910),
    _x("vfmseg.stage1", "cpu_op", 20, 400),
    _x("vfmseg.lr_forward", "cpu_op", 30, 300),
    _x("aten::addmm", "cpu_op", 35, 60),
    _x("cudaLaunchKernel", "cuda_runtime", 40, 45),
    _x("cudaLaunchKernel", "cuda_runtime", 52, 57),
    _x("aten::copy_", "cpu_op", 340, 360),
    _x("cudaMemcpyAsync", "cuda_runtime", 345, 350),
    _x("vfmseg.refine", "cpu_op", 450, 850),
    _x("vfmseg.hr_forward", "cpu_op", 460, 800),
    _x("cuLaunchKernelEx", "cuda_driver", 470, 475),
    _x("cudaLaunchKernel", "cuda_runtime", 600, 610),
    _x("cuLaunchKernel", "cuda_driver", 602, 608),
    _x("cudaMemsetAsync", "cuda_runtime", 820, 825),
    _x("cudaLaunchKernel", "cuda_runtime", 830, 835),
    _x("cudaLaunchKernel", "cuda_runtime", 950, 955),
    _x("cudaStreamSynchronize", "cuda_runtime", 980, 999),
    _x("gemm_a", "kernel", 100, 200),
    _x("gemm_b", "kernel", 150, 250),
    _x("Memcpy DtoH", "gpu_memcpy", 360, 370),
    _x("nvjet_tst", "kernel", 480, 560),
    _x("attention_qkv_kernel", "kernel", 620, 700),
    _x("Memset", "gpu_memset", 830, 840),
    _x("window_blend", "kernel", 845, 855),
    _x("elementwise", "kernel", 960, 990),
]
HOST = [e for e in EVENTS if e["cat"] in trace_mod.HOST_CATS]
DEVICE = [e for e in EVENTS if e["cat"] in trace_mod.DEVICE_CATS]
# device time by phase (us): gemm_b adds only the 50 us gemm_a leaves
# uncovered; the runtime call at 600 holds its own driver call (one launch);
# the memset goes with window_blend, the next kernel
DEVICE_US = {"vfmseg.lr_forward": 150, "vfmseg.stage1": 10,
             "vfmseg.hr_forward": 160, "vfmseg.refine": 20, "outside": 30}
# idle by the gap's midpoint: 0-100 at 50, 250-360 at 305, 370-480 at 425,
# 560-620 at 590, 700-830 at 765, 840-845 at 842.5, 855-960 at 907.5,
# 990-1000 at 995
IDLE_US = {"vfmseg.lr_forward": 100, "vfmseg.stage1": 110,
           "vfmseg.predict": 215, "vfmseg.hr_forward": 190,
           "vfmseg.refine": 5, "outside": 10}


def _trace(events=EVENTS):
    return trace_mod.Trace(list(events))


class _Readings:
    def __init__(self, trace, frames=2):
        self.trace = trace
        self.span_frames = list(range(frames))


def test_trace_reads_what_it_read_before():
    """``Trace``'s attributes and methods on the list, worked by hand."""
    t = _trace()
    assert t.window_s == pytest.approx(1000e-6)
    assert t.kernels == [(float(e["ts"]), float(e["ts"] + e["dur"]),
                          e["name"]) for e in DEVICE]
    assert t.host == [(float(e["ts"]), float(e["ts"] + e["dur"]), e["name"])
                      for e in HOST]
    assert t.busy_s == pytest.approx(370e-6)
    assert t.gaps == [(0.0, 100.0), (250.0, 360.0), (370.0, 480.0),
                      (560.0, 620.0), (700.0, 830.0), (840.0, 845.0),
                      (855.0, 960.0), (990.0, 1000.0)]
    assert t.kernel_s(["attention_qkv_kernel", "nvjet"]) == pytest.approx(
        160e-6)
    assert [n for n, _ in t.device_ops()] == [
        "gemm_a", "gemm_b", "nvjet_tst", "attention_qkv_kernel",
        "elementwise", "Memcpy DtoH", "Memset", "window_blend"]
    assert t.device_ops(2) == [("gemm_a", pytest.approx(100e-6)),
                               ("gemm_b", pytest.approx(100e-6))]
    # a gap is named by the innermost host event open at its midpoint; the
    # program's ranges are host events too
    assert t.idle_gaps() == [
        ("vfmseg.predict", pytest.approx(215e-6)),
        ("vfmseg.hr_forward", pytest.approx(190e-6)),
        ("vfmseg.stage1", pytest.approx(110e-6)),
        ("aten::addmm", pytest.approx(100e-6)),
        ("cudaStreamSynchronize", pytest.approx(10e-6)),
        ("vfmseg.refine", pytest.approx(5e-6))]


def test_ops_go_to_the_innermost_range_of_their_launch():
    """Kernels and the copy go by their launch call, the driver launch as
    the runtime ones, a nested driver call once; the memset where the next
    kernel goes; gaps by their midpoint; phases and ``outside`` sum to
    ``busy_s`` and to the idle time."""
    t = _trace()
    p = spans.Program(t)
    assert p.phases == {"vfmseg.predict", "vfmseg.stage1",
                        "vfmseg.lr_forward", "vfmseg.refine",
                        "vfmseg.hr_forward"}
    assert dict(p.device_s) == {k: pytest.approx(v * 1e-6)
                                for k, v in DEVICE_US.items()}
    assert dict(p.idle_s) == {k: pytest.approx(v * 1e-6)
                              for k, v in IDLE_US.items()}
    assert sum(p.device_s.values()) == pytest.approx(t.busy_s)
    assert sum(p.idle_s.values()) == pytest.approx(t.window_s - t.busy_s)


def test_group_ordinals_fold_into_their_phase():
    """``vfmseg.stage1#3`` is phase ``vfmseg.stage1``."""
    events = [dict(e, name=e["name"] + "#3") if e["name"] in (
        "vfmseg.stage1", "vfmseg.refine") else e for e in EVENTS]
    p = spans.Program(_trace(events))
    assert dict(p.device_s) == {k: pytest.approx(v * 1e-6)
                                for k, v in DEVICE_US.items()}


def test_lost_first_records_pair_from_the_end():
    """The profiler may lose the record of a span's first kernel, never its
    launch call: the other ops still find their own launches."""
    p = spans.Program(_trace([e for e in EVENTS if e["name"] != "gemm_a"]))
    # gemm_b no longer overlaps anything: 100 us of lr_forward
    assert dict(p.device_s) == {k: pytest.approx(v * 1e-6) for k, v in dict(
        DEVICE_US, **{"vfmseg.lr_forward": 100}).items()}


def test_pairing_gives_up_and_idle_stays():
    """An op with no launch call leaves the device times unread; the idle
    split does not need them."""
    events = EVENTS + [_x("late_kernel", "kernel", 995, 998)]
    p = spans.Program(_trace(events))
    assert p.device_s is None
    r = _Readings(_trace(events))
    assert spans.phase_ms(r, "vfmseg.hr_forward") is None
    assert spans.phase_ms(r, "vfmseg.hr_forward", idle=True) is not None


# each reader: (phase, idle)
READERS = {
    "lr_forward_ms.stream": ("vfmseg.lr_forward", False),
    "gate_ms.stream": ("vfmseg.stage1", False),
    "hr_forward_ms.stream": ("vfmseg.hr_forward", False),
    "blend_ms.stream": ("vfmseg.refine", False),
    "lr_forward_ms.dense": ("vfmseg.lr_forward", False),
    "gate_ms.dense": ("vfmseg.stage1", False),
    "hr_forward_ms.dense": ("vfmseg.hr_forward", False),
    "blend_ms.dense": ("vfmseg.refine", False),
    "idle.lr_forward_ms.dense": ("vfmseg.lr_forward", True),
    "idle.hr_forward_ms.dense": ("vfmseg.hr_forward", True),
}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_reads_ms_an_image(metric):
    """Each of the ten readers: its phase's time in ms over the span's two
    images; nothing without a trace, without device ops, or without a range
    of the program."""
    name, idle = READERS[metric]
    read = spec.reader(metric)
    us = (IDLE_US if idle else DEVICE_US)[name]
    assert read(_Readings(_trace())) == pytest.approx(us * 1e-3 / 2)
    assert read(_Readings(None)) is None
    no_device = [e for e in EVENTS if e["cat"] not in trace_mod.DEVICE_CATS]
    assert read(_Readings(_trace(no_device))) is None
    parent = [e for e in EVENTS if not e["name"].startswith("vfmseg.")]
    assert read(_Readings(_trace(parent))) is None


@pytest.mark.parametrize("config, mix, want", [
    ("dinov2_ms", "stream_gated", {"vfmseg.stage1", "vfmseg.lr_forward",
                                   "vfmseg.refine", "vfmseg.hr_forward"}),
    ("eva02_ms", "per_image_dense", {"vfmseg.predict", "vfmseg.stage1",
                                     "vfmseg.lr_forward", "vfmseg.refine",
                                     "vfmseg.hr_forward"})])
def test_toy_span_carries_the_program_ranges(config, mix, want):
    """The toy cell's traced span holds the program's ranges in its host
    events. The cell reports its kind's phase metrics; on the CPU no op ran
    on a device, so each reads nothing (as the roofline does) and the
    traced line leaves it out."""
    c = cell(config, mix)
    kind = ".stream" if c.mix["loop"] == "stream" else ".dense"
    mine = {m for m in READERS if m.endswith(kind)}
    assert mine <= {m["name"] for m in c.per_layer}
    lp = harness.loop_class(c.mix["loop"])(c, SEED, "cpu")
    lp.setup()
    r = lp.readings
    r.trace = trace_mod.profile(lp.span)
    assert spans.Program(r.trace).phases == want
    assert r.span_frames and not r.trace.kernels
    assert all(spec.reader(m)(r) is None for m in mine)
