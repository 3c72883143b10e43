"""One run of one cell: set-up, the measured window, the traced span, the
check, and the result line.

The traffic mix's ``loop`` names the module ``cardbench/loops/<loop>.py``
whose ``Loop`` drives the program; the cell's metrics are read by
``cardbench/metrics/<metric>.py`` (``spec.py``). With ``trace`` off the
line carries the cell's end-to-end metrics; with it on, the window runs
unprofiled as well (the rates and shares of the window come from it), then
a short span of the same work runs under the profiler for the device's busy
time, the kernels' rooflines and the breakdown, and the line carries the
per-layer metrics.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import time
from typing import Dict, List, Tuple

import torch

from cardbench import spec, trace as trace_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "vfmseg_tpu")


def loop_class(name: str):
    path = os.path.join(spec.HERE, "loops", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(
        f"cardbench_loop_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.Loop


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``vfmseg_tpu_torch`` is not ``vfmseg_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def device_info(device, chips: int, peak: int) -> Dict:
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    return dict(platform=platform, kind=kind, count=chips,
                memory_peak_bytes=int(peak),
                power_limit=power_limit() if device.type == "cuda" else "",
                torch=torch.__version__, cuda=torch.version.cuda)


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool,
        t_start: float, device, loop=None) -> Tuple[Dict, List[str]]:
    """Run ``cell`` once; returns the result line's object and the lines
    that end standard error (each number compared beside its limit).
    ``t_start``: the process's start on ``time.perf_counter``; ``loop``: a
    ``Loop`` class in place of the mix's own (the tests' faults)."""
    device = torch.device(device)
    cls = loop or loop_class(cell.mix["loop"])
    lp = cls(cell, seed, device)
    lp.setup()
    r = lp.readings
    r.setup_s = time.perf_counter() - t_start
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    lp.window(seconds)
    r.peak_bytes = (torch.cuda.max_memory_allocated(device)
                    if device.type == "cuda" else 0)
    if traced:
        r.trace = trace_mod.profile(lp.span)
    lp.release()
    result = lp.check()

    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.reader(m["name"])(r)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = device_info(device, cell.chips, r.peak_bytes)
    line = dict(correct=bool(result["correct"]), attempted=int(r.attempted),
                failed=int(result["failed"]), metrics=metrics, device=dev)
    if traced:
        dev["busy_s"] = r.trace.busy_s
        dev["window_s"] = r.trace.window_s
        line["breakdown"] = {
            "device_ops": [list(x) for x in r.trace.device_ops()],
            "idle_gaps": [list(x) for x in r.trace.idle_gaps()]}
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, (v, lim) in result["numbers"].items()}
    tail = [f"check {name} {v!r} limit {lim!r}"
            for name, (v, lim) in result["numbers"].items()]
    if result["missing"]:
        tail.insert(0, f"check missing frames {result['missing']}")
    line["_frames"] = result["frames"]
    return line, tail
