"""Recommendation traffic: a closed loop of
``LightFM.recommend(user_ids, k=k, train_interactions=train)`` calls, one
client, in the default mode; each call asks for ``users_per_call``
distinct users drawn uniformly from all users, a new batch every call.

Set-up makes the train interactions and the model's weights (on the
device) from the seed, exactly as ``drivers/eval.py`` makes them, and
makes one warm call.  Every request is timed on the host from call to
result; ``served_users_per_s`` is the users of the requests that finished
in the window over the time from its start to the end of the last of
them, ``request_p95_ms`` the 95th percentile of all their latencies (a
request's users are drawn before its clock starts).  The
warm call's results and the window's first and last are kept for the
check (``portbench/reference/topk.py``).
"""

from __future__ import annotations

import time

import numpy as np

from portbench import traced, work_recommend
from portbench.data import synth
from portbench.drivers import eval as eval_driver
from portbench.reference import topk


class Run(eval_driver.Run):
    """``drivers/eval.py``'s weights, model and release, serving ``recommend``."""

    def setup(self):
        from lightfm_tpu_torch import LightFM
        from lightfm_tpu_torch.state import ModelState

        torch = self.torch
        d, m = self.cfg["data"], self.cfg["model"]
        coo, self.cluster = synth.clustered_interactions(
            d["users"], d["items"], d["draws"], synth.sub_seed(self.seed, "interactions"),
            d["clusters"])
        self.train = coo.tocsr()
        user, item = self._tables()
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        self.model = LightFM(**m, device=self.device)
        self.model._state = ModelState(item, torch.ones_like(item), torch.zeros_like(item),
                                       user, torch.ones_like(user), torch.zeros_like(user),
                                       zero, zero.clone())
        self.model.n_users_, self.model.n_items_ = self.train.shape
        self.users = np.random.Generator(np.random.PCG64(synth.sub_seed(self.seed, "users")))
        self.kept = [self._call(self._users())]

    def _users(self) -> np.ndarray:
        """The next request's users, drawn before its clock starts."""
        return self.users.choice(self.train.shape[0], self.tr["users_per_call"],
                                 replace=False, shuffle=False).astype(np.int32)

    def _call(self, users):
        """One request: ``(users, scores, ids)``."""
        scores, ids = self.model.recommend(users, k=self.tr["k"],
                                           train_interactions=self.train)
        return users, scores, ids

    def window(self, seconds: float) -> dict:
        lat, first, last = [], None, None
        t0 = time.perf_counter()
        end = t0 + seconds
        t = t0
        while t < end:
            users = self._users()
            s = time.perf_counter()
            last = self._call(users)
            t = time.perf_counter()
            lat.append(t - s)
            if first is None:
                first = last
        self.kept += [first, last]
        return {"attempted": len(lat), "failed": 0, "metrics": {
            "served_users_per_s": len(lat) * self.tr["users_per_call"] / (t - t0),
            "request_p95_ms": float(np.percentile(np.asarray(lat) * 1e3, 95)),
        }}

    def traced(self) -> dict:
        """``trace_requests`` requests timed on the host, then as many under
        the profiler.  Returns what the per-layer readers read."""
        torch = self.torch
        n = int(self.tr["trace_requests"])
        batches = [self._users() for _ in range(2 * n)]
        t0 = time.perf_counter()
        for users in batches[:n]:
            self._call(users)
        users_per_s = n * self.tr["users_per_call"] / (time.perf_counter() - t0)
        with traced.profiled(torch, self.device) as prof:
            for users in batches[n:]:
                with torch.profiler.record_function(traced.PREFIX + "request"):
                    out = self._call(users)
        self.kept.append(out)
        return {
            "trace": prof.trace, "requests": n, "users_per_s": users_per_s,
            "flops_per_user": work_recommend.user_flops(self.train.shape[1],
                                                        self.cfg["model"]["no_components"]),
        }

    def _check(self, answer) -> dict:
        """The worst of each compared number over the kept requests, their
        results given by ``answer(users, scores, ids)``."""
        user, item = self._tables()
        D = self.cfg["model"]["no_components"]
        out = {"topk_outside_band": 0, "topk_score_gap": 0.0}
        for users, scores, ids in self.kept:
            got = topk.check(user, item, self.train, users, *answer(users, scores, ids), D)
            out = {k: max(out[k], got[k]) for k in out}
        return out

    def checks(self) -> dict:
        return self._check(lambda users, scores, ids: (scores, ids))

    def control(self) -> dict:
        """The top ``k`` of TF32-rounded operands put in the program's place."""
        user, item = self._tables()
        return self._check(lambda users, scores, ids: topk.top_k_tf32(
            user, item, self.train, users, ids.shape[1]))
