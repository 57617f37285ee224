"""Evaluation traffic on matrices the model has not seen: ``drivers/eval.py``'s
closed loop of ``LightFM.predict_rank`` calls, each on a new copy of the
next of ``test_sets`` held-out sets, with the same ``train`` object every
call.

Set-up makes the train interactions, ``test_sets`` held-out sets from
distinct sub-seeds and the model's weights (on the device) from the seed,
and makes one warm call.  In the window each call's copy is made before
its timer starts; a traced run makes its calls' copies before the traced
requests.  So no call's test matrix is an object an earlier call passed,
and what the model keeps for a caller's matrix (its ``sparse.Memo``, keyed
by the object) never serves a test matrix: the intersection check, the
rank preparation and the padded conversions run on every call.  Every
kept answer is held against the plain reference's bands of its own set.
"""

from __future__ import annotations

import time
import zlib

import numpy as np

from portbench.data import synth
from portbench.drivers import eval as eval_driver
from portbench.reference import ranks


class Run(eval_driver.Run):
    def setup(self):
        from lightfm_tpu_torch import LightFM
        from lightfm_tpu_torch.state import ModelState

        torch = self.torch
        d, m = self.cfg["data"], self.cfg["model"]
        coo, self.cluster = synth.clustered_interactions(
            d["users"], d["items"], d["draws"], synth.sub_seed(self.seed, "interactions"),
            d["clusters"])
        self.train = coo.tocsr()
        self.sets = [synth.held_out(self.train, self.cluster, self.tr["test_users"],
                                    self.tr["items_per_user"],
                                    synth.sub_seed(self.seed, f"test-{k}"), d["clusters"])
                     for k in range(int(self.tr["test_sets"]))]
        user, item = self._tables()
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        self.model = LightFM(**m, device=self.device)
        self.model._state = ModelState(item, torch.ones_like(item), torch.zeros_like(item),
                                       user, torch.ones_like(user), torch.zeros_like(user),
                                       zero, zero.clone())
        self.model.n_users_, self.model.n_items_ = self.train.shape
        self.results = {}
        self.made = 0  # test copies made so far
        self.queue = []  # copies made ahead of a traced run's requests
        self._keep([self._call()])

    def _fresh(self):
        """The next set's index and a new copy of it."""
        k = self.made % len(self.sets)
        self.made += 1
        return k, self.sets[k].copy()

    def _call(self, fresh=None):
        k, test = fresh or (self.queue.pop(0) if self.queue else self._fresh())
        return k, self.model.predict_rank(test, train_interactions=self.train).data

    def _keep(self, outputs):
        """Keep each distinct rank array of each set the calls returned."""
        for k, out in outputs:
            crc = zlib.crc32(np.ascontiguousarray(out).view(np.uint8))
            self.results.setdefault((k, crc), out)

    def window(self, seconds: float) -> dict:
        lat, outputs = [], []
        t0 = time.perf_counter()
        end = t0 + seconds
        t = t0
        while t < end:
            fresh = self._fresh()
            s = time.perf_counter()
            outputs.append(self._call(fresh))
            t = time.perf_counter()
            lat.append(t - s)
        self._keep(outputs)
        users = len(lat) * self.tr["test_users"]
        return {"attempted": len(lat), "failed": 0, "metrics": {
            "served_users_per_s": users / (t - t0),
            "request_p95_ms": float(np.percentile(np.asarray(lat) * 1e3, 95)),
        }}

    def traced(self) -> dict:
        """``drivers/eval.py``'s traced run, each of its requests on a copy
        made before the run."""
        self.queue = [self._fresh() for _ in range(2 * int(self.tr["trace_requests"]))]
        try:
            return super().traced()
        finally:
            self.queue = []

    def bands(self, k: int = 0):
        """The plain reference's bands of set ``k``, from weights it makes
        again from the seed."""
        user, item = self._tables()
        return ranks.rank_bands(user, item, self.sets[k], self.train)

    def checks(self) -> dict:
        worst = 0
        for k in sorted({k for k, _ in self.results}):
            lo, hi = self.bands(k)
            worst = max([worst] + [ranks.outside_band(r, lo, hi)
                                   for (j, _), r in self.results.items() if j == k])
        return {"ranks_outside_band": worst}

    def control(self) -> dict:
        """The reference's own ranks of the first set over TF32 operands put
        in the program's place."""
        user, item = self._tables()
        got = ranks.ranks_tf32(user, item, self.sets[0], self.train)
        return {"ranks_outside_band": ranks.outside_band(got, *self.bands(0))}
