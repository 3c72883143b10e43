"""Run one cell of the benchmark once on the card.

Usage, from the root of a checkout::

    python3 -m cardbench.run --workload dinov2_ms.eval_compact --seed 7 \\
        --seconds 30 --trace 0

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (images), ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each number the
correctness check compared, beside its limit. The same numbers end
standard error. Without a CUDA card, or with fewer than the cell asks for,
it prints no result and exits with 2; if JAX or the JAX package was loaded
by the time the window closed, with 3. The program's only build cache, its
CUDA library, lies in the checkout (``vfmseg_tpu_torch/_build/``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from cardbench import spec

    cell = spec.load_cell(args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"cardbench: the cell needs {cell.chips} CUDA card(s); this "
              f"machine has {cards}", file=sys.stderr)
        return 2

    from cardbench import harness

    line, tail = harness.run(cell, args.seed, args.seconds,
                             bool(args.trace), T_START,
                             torch.device("cuda", 0))
    frames = line.pop("_frames")
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"cardbench: JAX or the JAX package was loaded: {loaded}",
              file=sys.stderr)
        return 3
    print(json.dumps({"frames": frames}), file=sys.stderr)
    for text in tail:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
