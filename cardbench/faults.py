"""Faults planted under the timed path, for the checks' own tests and for
reading each fault at a cell's own size (``limits.py --fault``). Each is a
``Loop`` whose program breaks in one way; a sound check reads it as not
correct.

* ``altered_answer`` (stream): a 32 x 32 patch of every image's labels
  moved to the next class where they are produced;
* ``half_batch_stream``: half of each group's images never computed, their
  labels zeros;
* ``half_batch_train``: each step on the first half of its batch only, the
  mean taken over the rest;
* ``unchanged_state``: each step returns the state unchanged (the update
  undone).
"""

from __future__ import annotations

import torch

from cardbench import harness

_Stream = harness.loop_class("stream")
_Train = harness.loop_class("train")


class AlteredAnswer(_Stream):
    def _run(self, stop):
        c = self.cfg["num_classes"]
        for idx, labels in super()._run(stop):
            labels = labels.clone()
            labels[:32, :32] = (labels[:32, :32] + 1) % c
            yield idx, labels


class HalfBatchStream(_Stream):
    def _run(self, stop):
        for k, (idx, labels) in enumerate(super()._run(stop)):
            if k % self.group >= self.group // 2:
                labels = torch.zeros_like(labels)
            yield idx, labels


class HalfBatchTrain(_Train):
    def _one(self):
        batch = self.batches[self.steps_done % len(self.batches)]
        half = batch["img"].shape[0] // 2
        self.batches[self.steps_done % len(self.batches)] = {
            k: v[:half] for k, v in batch.items()}
        try:
            return super()._one()
        finally:
            self.batches[(self.steps_done - 1) % len(self.batches)] = batch


class UnchangedState(_Train):
    def _one(self):
        params = self.step.trainable()
        before = {n: p.detach().clone() for n, p in params.items()}
        metrics = super()._one()
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(before[n])
        return metrics


FAULTS = {"altered_answer": AlteredAnswer,
          "half_batch_stream": HalfBatchStream,
          "half_batch_train": HalfBatchTrain,
          "unchanged_state": UnchangedState}
