"""Training traffic: a closed loop of ``LightFM.fit`` calls on one model.

Set-up makes the interactions from the seed, builds the model and makes
one warm fit.  The window then calls ``fit`` back to back on the same model
and the same inputs; a fit starts only while the window has room for one
as long as the last.  ``train_examples_per_s`` is the interactions of the
fits that finished in the window over the time from the window's start to
the end of the last of them.

After the window, outside its time, one more fit is made on the same
model, with every cache the window warmed; its state before its first
step and after each of its first ``CHECK_STEPS`` steps is what the check
holds against the plain reference.
"""

from __future__ import annotations

import gc
import time

from portbench import traced, work
from portbench.data import synth
from portbench.reference import compare, warp

# The steps of the checked fit that the reference follows.  The limits
# compare the first gradient and the first step's change: the third step's
# change swings by seed with margin decisions that float32 order flips.
CHECK_STEPS = 3
# Untraced fits a traced run times for the rate that ``mfu.fit`` reads.
RATE_FITS = 3


class Run:
    def __init__(self, cell, seed: int, device):
        import torch

        self.torch = torch
        self.cfg = cell.config
        self.seed = seed
        self.device = device
        self.epochs = int(self.cfg["fit"]["epochs"])
        self.fits = 0  # fits made on the model so far
        self._refs = {}

    # -- set-up --------------------------------------------------------

    def _fit(self):
        self.model.fit(self.coo, epochs=self.epochs)
        self.fits += 1

    def setup(self):
        from lightfm_tpu_torch import LightFM

        d, m = self.cfg["data"], self.cfg["model"]
        self.coo, _ = synth.clustered_interactions(
            d["users"], d["items"], d["draws"], synth.sub_seed(self.seed, "interactions"),
            d["clusters"])
        self.model_seed = synth.sub_seed(self.seed, "model")
        self.model = LightFM(**m, random_state=self.model_seed, device=self.device)
        self._fit()
        if not self.model._staged_fast:
            raise RuntimeError("the warm fit did not train on the fast WARP path")
        self.nnz = self.coo.nnz
        self.n_batches = (self.model._staged_train_data.packed.shape[1]
                          // self.model._staged_batch_size)

    # -- window ----------------------------------------------------------

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        end = t0 + seconds
        done, started, last_end, last = 0, 0, t0, None
        while True:
            now = time.perf_counter()
            if now >= end or (last is not None and now + last > end):
                break
            started += 1
            self._fit()
            t = time.perf_counter()
            last = t - now
            if t <= end:
                done, last_end = done + 1, t
        if not done:
            raise RuntimeError(f"no fit finished within {seconds} s")
        rate = done * self.epochs * self.nnz / (last_end - t0)
        self._check_fit()
        return {"attempted": started, "failed": 0,
                "metrics": {"train_examples_per_s": rate}}

    def _check_fit(self):
        """One fit whose state before its first step and after each of its
        first ``CHECK_STEPS`` steps is kept (on the host) for the check."""
        from lightfm_tpu_torch import fast_warp

        snaps, count = {}, [0]
        keep = range(CHECK_STEPS + 1)

        def snapshot(state):
            return {k: getattr(state, k).detach().to("cpu", copy=True)
                    for k in ("item_table", "item_acc", "user_table", "user_acc")}

        def watch(step):
            def inner(state, *args, **kwargs):
                if count[0] == 0:
                    snaps[0] = snapshot(state)
                out = step(state, *args, **kwargs)
                count[0] += 1
                if count[0] in keep:
                    snaps[count[0]] = snapshot(out)
                return out
            return inner

        self.fits_before = self.fits
        with traced.Patches() as p:
            p.wrap(fast_warp, "warp_pool_step", watch)
            self._fit()
        if sorted(snaps) != list(keep):
            raise RuntimeError("the checked fit did not train on the fast WARP path")
        self.snaps = snaps

    # -- traced window ---------------------------------------------------

    def traced(self) -> dict:
        """``RATE_FITS`` untraced fits timed on the host; then a steady run of
        steps (the second epoch's after its first, or the first epoch's if
        there is no second), timed in one untraced fit and profiled in the
        next, with spans and the kernel wrappers' arguments recorded.
        Returns what the per-layer readers read."""
        torch = self.torch
        from lightfm_tpu_torch import fast_warp

        t0 = time.perf_counter()
        for _ in range(RATE_FITS):
            self._fit()
        rate = RATE_FITS * self.epochs * self.nnz / (time.perf_counter() - t0)

        e = min(1, self.epochs - 1)
        first = e * self.n_batches + (1 if self.n_batches > 1 else 0)
        last = (e + 1) * self.n_batches - 1  # the last traced step
        # The profiler slows the host's enqueue inside the steps, so the idle
        # share takes the wall time of the same steps in an untraced fit.
        steps_wall_s = self._timed_steps(first, last)
        prof = traced.Profiler(torch, self.device)
        calls = {"k1": [], "step": 0}

        def k1(table, acc, sidx, swg, *a, **k):
            if prof.active:
                calls["k1"].append((sidx.shape[0], table.shape[1], sidx))

        def window(step):
            def inner(*a, **k):
                i = calls["step"]
                calls["step"] += 1
                if i == first:
                    prof.start()
                out = step(*a, **k)
                if i == last:
                    prof.stop()
                return out
            return inner

        targets = [
            (fast_warp, "_unpack_batch5", "unpack"),
            (fast_warp, "warp_pool_step", "step"),
            (fast_warp, "_apply_pool_updates", "updates"),
            (fast_warp, "sorted_adagrad_update", "k1"),
        ]
        with traced.Patches() as p:
            traced.span_all(torch, p, targets, {"k1": k1})
            p.wrap(fast_warp, "warp_pool_step", window)
            self._fit()
        if prof.trace is None:
            raise RuntimeError(f"the traced fit took {calls['step']} steps, not {last + 1}")
        k1_calls = []
        for M, W, sidx in calls["k1"]:
            distinct = int((sidx[1:] != sidx[:-1]).sum()) + 1 if M else 0
            k1_calls.append((M, W, distinct))
        d = self.cfg["model"]
        self._check_fit()
        return {
            "trace": prof.trace, "fits": RATE_FITS + 2, "steps": last + 1 - first,
            "steps_wall_s": steps_wall_s, "examples_per_s": rate,
            "flops_per_example": work.warp_example_flops(d["no_components"], d["max_sampled"]),
            "k1_calls": k1_calls,
        }

    def _timed_steps(self, first: int, last: int) -> float:
        """Seconds from the start of step ``first`` to the end of step
        ``last`` of one untraced fit, synchronised at both ends."""
        from lightfm_tpu_torch import fast_warp

        sync = traced.Profiler(self.torch, self.device).sync
        marks, count = {}, [0]

        def timer(step):
            def inner(*a, **k):
                i = count[0]
                count[0] += 1
                if i == first:
                    sync()
                    marks["start"] = time.perf_counter()
                out = step(*a, **k)
                if i == last:
                    sync()
                    marks["end"] = time.perf_counter()
                return out
            return inner

        with traced.Patches() as p:
            p.wrap(fast_warp, "warp_pool_step", timer)
            self._fit()
        return marks["end"] - marks["start"]

    # -- check -------------------------------------------------------------

    def release(self):
        self.model = None
        gc.collect()
        self.torch.cuda.empty_cache()

    def reference(self, rounding: str = "bf16") -> dict:
        """The plain reference's state before the checked fit's first step
        and after each of its first ``CHECK_STEPS`` steps, computed in
        ``rounding``."""
        m = self.cfg["model"]
        D = m["no_components"]
        if rounding in self._refs:
            return self._refs[rounding]
        self._refs[rounding] = warp.first_steps(
            self.coo, D=D, W=((D + 1 + 7) // 8) * 8, K=m["max_sampled"], lr=m["learning_rate"],
            batch_size=m["batch_size"], pool_size=self.cfg["fit"]["pool_size"],
            model_seed=self.model_seed, fits_before=self.fits_before, epochs=self.epochs,
            steps=range(CHECK_STEPS + 1), device=self.device, rounding=rounding)
        return self._refs[rounding]

    def compare(self, states: dict, ref: dict) -> dict:
        D = self.cfg["model"]["no_components"]
        return compare.fit_checks(states, ref, D, ((D + 1 + 7) // 8) * 8, CHECK_STEPS)

    def checks(self) -> dict:
        """The program's first steps against the plain reference's."""
        return self.compare(self.snaps, self.reference())

    def detail(self) -> dict:
        D = self.cfg["model"]["no_components"]
        return compare.fit_detail(self.snaps, self.reference(), D, ((D + 1 + 7) // 8) * 8)

    def control(self) -> dict:
        """The reference in float8 put in the program's place."""
        return self.compare(self.reference("fp8"), self.reference())
