"""One client, one image at a time: the eval CLI's per-image predictor
(``make_shape_aware_predict_fn`` with the configuration's test settings) in
a closed loop over the frame pool.

Each latency runs from the call to the labels synchronised on the device;
the window takes images until ``seconds`` have passed, and ends with the
last one's labels. Every image has one shape, so set-up warms the path up
with ``warm_images`` calls.
"""

from __future__ import annotations

import time

import torch

from cardbench import program
from cardbench.inference import InferenceLoop


class Loop(InferenceLoop):
    def warm(self) -> None:
        self.path = program.DensePredictor(self.model, self.test_cfg)
        for i in range(int(self.mix["warm_images"])):
            self._one(i % self.frames.shape[0])

    def _one(self, idx: int) -> torch.Tensor:
        labels = self.path(self.frames[idx:idx + 1], self.hw)[0]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return labels

    def drive(self) -> None:
        for idx in self.sample:
            self.keep(idx, self._one(idx))

    def window(self, seconds: float) -> None:
        r = self.readings
        pool = self.frames.shape[0]
        done, lat = [], []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        while time.perf_counter() < deadline:
            idx = i % pool
            t = time.perf_counter()
            labels = self._one(idx)
            lat.append(time.perf_counter() - t)
            done.append(idx)
            self.keep(idx, labels)
            i += 1
        r.window_s = time.perf_counter() - t0
        r.attempted = r.images = len(done)
        r.frames_done = done
        r.latencies_s = lat

    def span(self) -> None:
        n = int(self.mix["profile_images"])
        for idx in range(n):
            self._one(idx % self.frames.shape[0])
        self.readings.span_frames = [i % self.frames.shape[0]
                                     for i in range(n)]
