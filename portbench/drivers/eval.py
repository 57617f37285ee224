"""Evaluation traffic: a closed loop of ``LightFM.predict_rank`` calls, one
client, the same test matrix every call (as the per-epoch metric loop
sends it).

Set-up makes the train interactions, the held-out test items and the
model's weights (on the device) from the seed, and makes one warm call.
Every request is timed on the host from call to result;
``served_users_per_s`` is the test users of the requests that finished in
the window over the time from its start to the end of the last of them,
``request_p95_ms`` the 95th percentile of all their latencies.
"""

from __future__ import annotations

import gc
import time
import zlib

import numpy as np

from portbench import traced, work
from portbench.data import synth
from portbench.reference import ranks


class Run:
    def __init__(self, cell, seed: int, device):
        import torch

        self.torch = torch
        self.cfg = cell.config
        self.tr = cell.traffic
        self.seed = seed
        self.device = device

    def _tables(self):
        d, m = self.cfg["data"], self.cfg["model"]
        D = m["no_components"]
        W = ((D + 1 + 7) // 8) * 8
        return synth.planted_tables(self.torch, d["users"], d["items"], D, W, self.cluster,
                                    d["clusters"], synth.sub_seed(self.seed, "weights"),
                                    self.device)

    def setup(self):
        from lightfm_tpu_torch import LightFM
        from lightfm_tpu_torch.state import ModelState

        torch = self.torch
        d, m = self.cfg["data"], self.cfg["model"]
        coo, self.cluster = synth.clustered_interactions(
            d["users"], d["items"], d["draws"], synth.sub_seed(self.seed, "interactions"),
            d["clusters"])
        self.train = coo.tocsr()
        self.test = synth.held_out(self.train, self.cluster, self.tr["test_users"],
                                   self.tr["items_per_user"], synth.sub_seed(self.seed, "test"),
                                   d["clusters"])
        user, item = self._tables()
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        self.model = LightFM(**m, device=self.device)
        self.model._state = ModelState(item, torch.ones_like(item), torch.zeros_like(item),
                                       user, torch.ones_like(user), torch.zeros_like(user),
                                       zero, zero.clone())
        self.model.n_users_, self.model.n_items_ = self.train.shape
        self.results = {}
        self._keep([self._call()])

    def _call(self):
        return self.model.predict_rank(self.test, train_interactions=self.train).data

    def _keep(self, outputs):
        """Keep each distinct rank array the calls returned, for the check."""
        for out in outputs:
            self.results.setdefault(zlib.crc32(np.ascontiguousarray(out).view(np.uint8)), out)

    def window(self, seconds: float) -> dict:
        lat, outputs = [], []
        t0 = time.perf_counter()
        end = t0 + seconds
        t = t0
        while t < end:
            s = time.perf_counter()
            outputs.append(self._call())
            t = time.perf_counter()
            lat.append(t - s)
        self._keep(outputs)
        users = len(lat) * self.tr["test_users"]
        return {"attempted": len(lat), "failed": 0, "metrics": {
            "served_users_per_s": users / (t - t0),
            "request_p95_ms": float(np.percentile(np.asarray(lat) * 1e3, 95)),
        }}

    def traced(self) -> dict:
        """``trace_requests`` requests timed on the host, then as many under
        the profiler, with spans and the kernel wrappers' arguments
        recorded.  Returns what the per-layer readers read."""
        torch = self.torch
        from lightfm_tpu_torch import model
        from lightfm_tpu_torch.ops import ranking

        n = int(self.tr["trace_requests"])
        t0 = time.perf_counter()
        outputs = [self._call() for _ in range(n)]
        users_per_s = n * self.tr["test_users"] / (time.perf_counter() - t0)

        calls = {"k2": []}

        def k2(u_aug, items_aug, ts, *a, **k):
            calls["k2"].append((u_aug.shape[0], ts.shape[1]))

        targets = [
            (model.LightFM, "_check_test_train_intersections", "intersections"),
            (ranking, "_prepare_rank_tiers", "rank_prep"),
            (ranking, "rank_counts", "k2"),
            (ranking, "pair_scores", "pair_scores"),
        ]
        with traced.Patches() as p:
            traced.span_all(torch, p, targets, {"k2": k2})
            with traced.profiled(torch, self.device) as prof:
                for _ in range(n):
                    with torch.profiler.record_function(traced.PREFIX + "request"):
                        outputs.append(self._call())
        self._keep(outputs)
        D = self.cfg["model"]["no_components"]
        return {
            "trace": prof.trace, "requests": n, "users_per_s": users_per_s,
            "flops_per_user": work.rank_call_flops(
                1, self.train.shape[1], D, self.tr["items_per_user"]),
            # K2's calls by users and test slots, over the catalog's items at
            # the width the scores need (D + 2: embedding, item bias, user bias).
            "k2_calls": calls["k2"], "k2_items": self.train.shape[1], "k2_width": D + 2,
        }

    def release(self):
        self.model = None
        gc.collect()
        self.torch.cuda.empty_cache()

    def bands(self):
        """The plain reference's bands, from weights it makes again from
        the seed."""
        user, item = self._tables()
        return ranks.rank_bands(user, item, self.test, self.train)

    def checks(self) -> dict:
        lo, hi = self.bands()
        worst = max(ranks.outside_band(r, lo, hi) for r in self.results.values())
        return {"ranks_outside_band": worst}

    def control(self) -> dict:
        """The reference's own ranks over TF32 operands put in the
        program's place."""
        user, item = self._tables()
        got = ranks.ranks_tf32(user, item, self.test, self.train)
        return {"ranks_outside_band": ranks.outside_band(got, *self.bands())}
