"""What the benchmark loads: no JAX and no JAX package, compared by whole
top-level module names (``vfmseg_tpu_torch`` is the port, not
``vfmseg_tpu``); and the reference loads nothing of the program."""

import json
import subprocess
import sys

from cardbench_toys import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "vfmseg_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    top = _loaded(
        "import json\n"
        "import cardbench.run, cardbench.harness, cardbench.limits\n"
        "from cardbench import harness, spec\n"
        "for loop in ('stream', 'per_image'): harness.loop_class(loop)\n"
        "b = json.load(open('BENCHMARK.json'))\n"
        "for m in b['per_layer'] + b['end_to_end']:\n"
        "    spec.reader(m['name'])")
    assert "vfmseg_tpu_torch" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    top = _loaded("import cardbench.reference.model, cardbench.check")
    assert not top & (FORBIDDEN | {"vfmseg_tpu_torch"})


def test_forbidden_names_are_whole():
    from cardbench import harness

    saved = dict(sys.modules)
    try:
        sys.modules["vfmseg_tpu_torch_fake"] = sys
        assert "vfmseg_tpu" not in harness.forbidden_modules()
        sys.modules["jax.numpy"] = sys
        assert harness.forbidden_modules() == ["jax"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
