"""One rank of the gloo group that tests/test_torch_distributed.py starts:
``python torch_dist_worker.py RANK WORLD PORT TASK_JSON OUT_DIR``. It
joins the group through the port's ``mesh.init_distributed`` (torchrun's
variables set here), runs every case the task names
(``torch_dist_cases.run``) and writes each result to
``OUT_DIR/<case>.rank<RANK>.npz``; an error goes to
``OUT_DIR/error.rank<RANK>.txt``. Every collective times out after 90 s.
"""

import json
import os
import sys
import traceback

rank, world, port, task_path, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                         sys.argv[3], sys.argv[4],
                                         sys.argv[5])
os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                  LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                  MASTER_PORT=port)
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from vfmseg_tpu_torch.parallel import mesh  # noqa: E402

try:
    mesh.init_distributed("cpu", timeout_s=90)
    with open(task_path) as f:
        task = json.load(f)
    import torch_dist_cases  # noqa: E402

    for name in task["cases"]:
        result = torch_dist_cases.run(name, task, out_dir)
        np.savez(os.path.join(out_dir, f"{name}.rank{rank}.npz"), **result)
except Exception:  # noqa: BLE001
    with open(os.path.join(out_dir, f"error.rank{rank}.txt"), "w") as f:
        f.write(traceback.format_exc())
    raise
finally:
    mesh.shutdown()
