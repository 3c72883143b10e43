"""Faults planted in the Rein + Mask2Former slide cell's program, for the
check's own tests and for reading each fault at the cell's own size. Each
is a ``Loop`` of ``loops/per_image_slide.py`` whose program breaks in one
way before it is warmed up; a sound check reads it as not correct.

* ``masks_at_06``: the decoder's cross-attention masks thresholded at
  ``sigmoid < 0.6`` in place of 0.5;
* ``skipped_layer``: the middle decoder layer passes its queries on
  unchanged.

    python3 -m cardbench.faults_rein_m2f --fault masks_at_06 --seeds 11,12
"""

import argparse
import json
import sys

import torch
from torch import nn

from cardbench import harness, limits, spec

WORKLOAD = "rein_m2f.eval_slide"
_Slide = harness.loop_class("per_image_slide")


class MasksAt06(_Slide):
    def calibrate(self) -> None:
        def mask(logits: torch.Tensor) -> torch.Tensor:
            am = (torch.sigmoid(logits.float()) < 0.6).flatten(2)
            return am & ~am.all(-1, keepdim=True)

        self.model.decode_head._mask = mask


class _PassOn(nn.Module):
    def forward(self, query, *args):
        return query


class SkippedLayer(_Slide):
    def calibrate(self) -> None:
        head = self.model.decode_head
        setattr(head, f"decoder_layer{head.num_decoder_layers // 2}",
                _PassOn())


FAULTS = {"masks_at_06": MasksAt06, "skipped_layer": SkippedLayer}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(WORKLOAD)
    for s in args.seeds.split(","):
        print(json.dumps(limits.readings(cell, int(s),
                                         torch.device("cuda", 0),
                                         FAULTS[args.fault])), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
