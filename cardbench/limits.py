"""The readings that the check's limits are set from (not part of a benchmark
run).

For each seed: the cell's set-up as a run makes it, then the timed path
driven over the check's sample at the timed sizes (``drive_sample``: one
pass of the stream over the pool, the per-image predictor on each sampled
frame; a training cell's first steps, which set-up runs), judged against the
reference; then the control (``control``: the reference with its products in
float8 put in the program's place), judged the same way. With ``--fault``, a
planted fault (``faults.py``) in the program's place and no control. Prints
one JSON line a seed: each number compared, for the program and the
control, and each frame's (or step's) readings.

    python3 -m cardbench.limits --workload dinov2_ms.eval_compact \\
        --seeds 11,12,13
"""

import argparse
import json
import sys
import time

import torch

from cardbench import faults, harness, spec


def readings(cell, seed: int, device, fault=None) -> dict:
    t0 = time.perf_counter()
    lp = (fault or harness.loop_class(cell.mix["loop"]))(cell, seed, device)
    lp.setup()
    setup_s = time.perf_counter() - t0
    lp.drive_sample()
    lp.release()
    got = lp.check()
    out = dict(seed=seed, setup_s=setup_s,
               skip=getattr(lp, "skip", None),
               program={k: v for k, (v, _) in got["numbers"].items()},
               frames=got["frames"])
    if fault is None:
        ctl = lp.control()
        out.update(control={k: v for k, (v, _) in ctl["numbers"].items()},
                   control_frames=ctl["frames"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS),
                    help="read a planted fault in place of the program")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    fault = faults.FAULTS[args.fault] if args.fault else None
    for s in args.seeds.split(","):
        print(json.dumps(readings(cell, int(s), torch.device("cuda", 0),
                                  fault)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
