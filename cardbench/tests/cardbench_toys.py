"""Toy cells for the CPU tests: the two configurations cut to toy widths
(``toy/toy_<config>.json``) under toy copies of the mixes
(``toy/toy_<mix>.json``: 4 frames of 128 x 256, crops of 64)."""

import json
import os

from cardbench import spec

TOY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "toy")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(TOY)))


def toy(name: str) -> dict:
    with open(os.path.join(TOY, f"{name}.json")) as f:
        return json.load(f)


def bench() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


# the train cell's metrics, as its entries in BENCHMARK.json will name them
TRAIN_END_TO_END = [dict(name="train_steps_per_s", unit="steps/s")]
TRAIN_PER_LAYER = [dict(name=n, unit="%") for n in (
    "attention_roofline.train", "mfu.train", "idle.train")] + [
    dict(name="peak_mem_gib.train", unit="GiB")]


def cell(config: str, mix: str, name: str = "toy") -> spec.Cell:
    """A toy cell reporting the metrics of ``BENCHMARK.json``'s first cell
    under ``mix`` (a training mix: ``setup_s`` and the train cell's
    metrics)."""
    b = bench()
    m = toy(f"toy_{mix}")
    if m["loop"] == "train":
        e2e = [x for x in b["end_to_end"] if x["name"] == "setup_s"
               ] + TRAIN_END_TO_END
        layer = TRAIN_PER_LAYER
    else:
        real = spec.load_cell([w["name"] for w in b["workloads"]
                               if w["traffic"] == mix][0])
        e2e, layer = real.end_to_end, real.per_layer
    return spec.Cell(name=name, chips=1, config=toy(f"toy_{config}"), mix=m,
                     end_to_end=e2e, per_layer=layer)
