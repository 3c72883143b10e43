"""The harness on the CPU at toy sizes: the loops, the metric readers and
the result line; a cell added by files and an entry alone; the check
failing under planted faults and under the control; and ``cardbench.run``
refusing to run without a card."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from cardbench import faults, harness, limits, program, spec
from cardbench_toys import REPO, TOY, bench, cell, toy

SEED = 2 ** 31 + 12345


def _run(c, traced=False, loop=None):
    return harness.run(c, SEED, 5.0, traced, time.perf_counter(), "cpu",
                       loop=loop)


E2E = {"stream_gated": {"images_per_s", "setup_s"},
       "per_image_dense": {"dense_images_per_s", "image_latency_p95_ms",
                           "setup_s"},
       "train_bs2": {"train_steps_per_s", "setup_s"}}


@pytest.mark.parametrize("config, mix", [("dinov2_ms", "stream_gated"),
                                         ("eva02_ms", "per_image_dense"),
                                         ("dinov2_ms", "train_bs2")])
def test_toy_cell_runs_and_is_correct(config, mix):
    line, tail = _run(cell(config, mix))
    line.pop("_frames")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0, (
        line["attempted"], tail)
    assert set(line["metrics"]) == E2E[mix]
    assert tail == [f"check {k} {v['value']!r} limit {v['limit']!r}"
                    for k, v in line["checks"].items()]
    json.dumps(line)


def test_traced_line_carries_the_per_layer_metrics():
    line, _ = _run(cell("dinov2_ms", "stream_gated"), traced=True)
    line.pop("_frames")
    assert list(line)[-1] == "checks"
    m = line["metrics"]
    assert {"compact.refined_share", "compact.pad_share", "mfu.stream",
            "idle.stream"} <= set(m)
    assert "images_per_s" not in m
    assert 0 < m["compact.refined_share"]["value"] < 100
    assert 0 < m["mfu.stream"]["value"] < 100
    # no kernel ran on the CPU: the roofline reads nothing, not 0
    assert "attention_roofline.stream" not in m
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0


def test_a_cell_is_new_files_and_an_entry(tmp_path):
    """A new configuration and mix are found by name from their files, a
    new ``workloads`` entry and its name in the metrics' lists, with no
    file of the harness changed."""
    b = bench()
    (tmp_path / "cardbench" / "mixes").mkdir(parents=True)
    (tmp_path / "cardbench" / "configs").mkdir()
    shutil.copy(os.path.join(TOY, "toy_eva02_ms.json"),
                tmp_path / "cardbench" / "configs" / "toy_new.json")
    shutil.copy(os.path.join(TOY, "toy_stream_gated.json"),
                tmp_path / "cardbench" / "mixes" / "toy_mix.json")
    b["configs"].append(dict(name="toy_new", source="https://example.org",
                             file="cardbench/configs/toy_new.json",
                             reduced=[], why="a toy"))
    b["workloads"].append(dict(name="toy_new.stream", config="toy_new",
                               traffic="toy_mix", chips=1, why="a toy"))
    for m in b["end_to_end"] + b["per_layer"]:
        if "dinov2_ms.eval_compact" in m.get("workloads", ()):
            m["workloads"].append("toy_new.stream")
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(b))
    c = spec.load_cell("toy_new.stream", str(path))
    assert c.mix["loop"] == "stream" and c.config["name"] == "toy_eva02_ms"
    assert {m["name"] for m in c.end_to_end} == {"images_per_s", "setup_s"}
    line, _ = _run(c)
    assert line["correct"] and "images_per_s" in line["metrics"]


@pytest.mark.parametrize("fault, mix", [
    ("altered_answer", "stream_gated"), ("half_batch_stream", "stream_gated"),
    ("half_batch_train", "train_bs2"), ("unchanged_state", "train_bs2")])
def test_planted_faults_read_not_correct(fault, mix):
    line, tail = _run(cell("dinov2_ms", mix), loop=faults.FAULTS[fault])
    assert not line["correct"]
    assert line["failed"] > 0
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("config, mix", [("dinov2_ms", "stream_gated"),
                                         ("eva02_ms", "per_image_dense")])
def test_control_reads_not_correct(config, mix):
    """The control: the reference with its products in float8 put in the
    program's place fails the check that the program passes."""
    lp = harness.loop_class(toy(f"toy_{mix}")["loop"])(
        cell(config, mix), SEED, "cpu")
    lp.setup()
    lp.release()
    got = lp.control()
    assert not got["correct"], got["numbers"]


@pytest.mark.card
def test_control_reads_not_correct_on_the_card(card):
    """The control at the cell's own size (run on the card)."""
    c = spec.load_cell("dinov2_ms.eval_compact")
    lp = harness.loop_class(c.mix["loop"])(c, SEED, card)
    lp.setup()
    lp.release()
    got = lp.control()
    assert not got["correct"], got["numbers"]


def test_run_without_a_card_fails_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "-m", "cardbench.run", "--workload",
         "dinov2_ms.eval_compact", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_run_outside_a_checkout_fails(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    has no program to run."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "cardbench"), tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "cardbench.run", "--workload",
         "dinov2_ms.eval_compact", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout == ""


def test_calibration_counts_the_program_at_the_scale_found():
    """The bisection works on scaled logits of one pass; the refined counts
    it hands on are the program's own at the scale it found."""
    c = cell("dinov2_ms", "stream_gated")
    lp = harness.loop_class("stream")(c, SEED, "cpu")
    lp.setup()
    conf = float(lp.test_cfg["conf"])
    shares = [program.stage1_confidence(lp.model, lp.test_cfg,
                                        lp.frames[i:i + 1])
              for i in range(lp.frames.shape[0])]
    want = [int((s < conf).sum()) for s in shares]
    assert lp.readings.refined == want
    windows = sum(s.numel() for s in shares)
    assert lp.skip == pytest.approx(1 - sum(want) / windows)


@pytest.mark.parametrize("mix", ["stream_gated", "per_image_dense",
                                 "train_bs2"])
def test_limit_readings_drive_every_loop_alike(mix):
    """``limits.py`` drives each loop by the same calls, and reads the
    program and the control on each."""
    got = limits.readings(cell("dinov2_ms", mix), SEED, "cpu")
    assert set(got["program"]) == set(got["control"])
    assert got["frames"] and got["control_frames"]


def test_balanced_order_evens_the_groups():
    """Frames regrouped so each group's windows sent on differ by at most
    one where the frames allow it; the order is a permutation."""
    import random

    from cardbench import traffic

    rs = random.Random(3)
    for _ in range(20):
        sizes = [rs.randint(0, 17) for _ in range(32)]
        order = traffic.balanced_order(sizes, 8)
        assert sorted(order) == list(range(32))
        sums = [sum(sizes[i] for i in order[g:g + 8])
                for g in range(0, 32, 8)]
        assert max(sums) - min(sums) <= 1, sums
