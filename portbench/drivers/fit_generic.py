"""Training traffic on the generic path: a closed loop of
``LightFM.fit(train, item_features=tags)`` calls on one model.

Set-up makes the interactions and the item tags from the seed, builds the
model and makes one warm fit, which must train on the generic path
(``_staged_fast`` False) and mark the parts of its epoch
(``GENERIC_SPANS``): a program that does not cannot give the cell's
per-layer metrics, and the run stops there.  The window then calls ``fit``
back to back on the same model and inputs; a fit starts only while the
window has room for one as long as the last.  ``train_examples_per_s`` is
the interactions of the fits that finished in the window over the time
from the window's start to the end of the last of them.

After the window, outside its time, one more fit is made on the same
model; its state before its first step and after each of its first
``CHECK_STEPS`` steps (tables, accumulators and both log scales) is what
the check holds against the plain reference
(``portbench/reference/warp_generic.py``).  Its tables and log scales
after the first epoch's last step and before the second epoch's first
step hold the end-of-epoch fold, which the check holds against the
reference's fold of the former (``fold_gap``).  The steps are watched
through ``losses.LOSS_STEPS["warp"]``, the step the generic epoch calls.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from portbench import traced, work_hybrid
from portbench.data import synth, tags
from portbench.drivers import fit
from portbench.reference import compare, warp_generic

CHECK_STEPS, RATE_FITS = fit.CHECK_STEPS, fit.RATE_FITS
# Spans of the generic epoch that a program marking its step's parts makes
# (the end-of-epoch fold's even where a fault replaces the step).
GENERIC_SPANS = ("step.score", "step.update", "step.l2", "epoch.l2_fold")
FIELDS = ("item_table", "item_acc", "user_table", "user_acc", "item_log_scale",
          "user_log_scale")


@contextlib.contextmanager
def wrapped_step(make):
    """``losses.LOSS_STEPS["warp"]`` replaced by ``make(step)`` in the body."""
    from lightfm_tpu_torch import losses

    step = losses.LOSS_STEPS["warp"]
    losses.LOSS_STEPS["warp"] = make(step)
    try:
        yield
    finally:
        losses.LOSS_STEPS["warp"] = step


def _ahead_of(calls: dict):
    """A step wrapper calling ``calls[i]()`` ahead of step ``i`` (counted
    from 0)."""
    def make(step):
        count = [0]

        def inner(*a, **k):
            i = count[0]
            count[0] += 1
            if i in calls:
                calls[i]()
            return step(*a, **k)
        return inner
    return make


class Run(fit.Run):
    """``drivers/fit.py``'s run (its window, release and check) on the
    generic path, with item tags."""

    def __init__(self, cell, seed: int, device):
        super().__init__(cell, seed, device)
        self.D = self.cfg["model"]["no_components"]
        self.W = ((self.D + 1 + 7) // 8) * 8

    # -- set-up --------------------------------------------------------

    def _fit(self):
        self.model.fit(self.coo, item_features=self.tags, epochs=self.epochs)
        self.fits += 1

    def setup(self):
        from lightfm_tpu_torch import LightFM, observability

        d, m = self.cfg["data"], self.cfg["model"]
        self.coo, _ = synth.clustered_interactions(
            d["users"], d["items"], d["draws"], synth.sub_seed(self.seed, "interactions"),
            d["clusters"])
        self.tags = tags.item_tags(d["items"], synth.sub_seed(self.seed, "tags"),
                                   **self.cfg["tags"])
        self.model_seed = synth.sub_seed(self.seed, "model")
        self.model = LightFM(**m, random_state=self.model_seed, device=self.device)
        with observability.recording() as rec:
            self._fit()
        if self.model._staged_fast is not False:
            raise RuntimeError("the warm fit did not train on the generic path")
        if not any(rec.named(n) for n in GENERIC_SPANS):
            raise RuntimeError(f"the program marks none of {GENERIC_SPANS} in its generic "
                               "epoch, so this cell's per-layer metrics cannot be read on it")
        self.nnz = self.coo.nnz
        self.n_batches = (self.model._staged_train_data.packed.shape[1]
                          // self.model._staged_batch_size)
        per_item = np.diff(self.tags.indptr)
        self.t_pos = float(per_item[self.coo.col].mean())
        self.t_neg = float(per_item.mean())

    # -- window (``fit.Run.window``) ----------------------------------------

    def _check_fit(self):
        """One fit whose state before its first step and after each of its
        first ``CHECK_STEPS`` steps is kept (on the host) for the check, and
        its tables and log scales on both sides of the first epoch's end."""
        snaps, fold, count = {}, {}, [0]
        n = self.n_batches

        def snapshot(state, fields=FIELDS):
            return {k: getattr(state, k).detach().to("cpu", copy=True) for k in fields}

        def watch(step):
            def inner(state, *args, **kwargs):
                if count[0] == 0:
                    snaps[0] = snapshot(state)
                if count[0] == n:
                    fold["after"] = snapshot(state, warp_generic.FOLD_FIELDS)
                out = step(state, *args, **kwargs)
                count[0] += 1
                if count[0] <= CHECK_STEPS:
                    snaps[count[0]] = snapshot(out)
                if count[0] == n:
                    fold["before"] = snapshot(out, warp_generic.FOLD_FIELDS)
                return out
            return inner

        self.fits_before = self.fits
        with wrapped_step(watch):
            self._fit()
        if sorted(snaps) != list(range(CHECK_STEPS + 1)) or len(fold) != 2:
            raise RuntimeError("the checked fit did not train on the generic WARP step "
                               "for more than one epoch")
        self.snaps, self.fold = snaps, fold

    # -- traced window ---------------------------------------------------

    def _steady_steps(self):
        """The traced run of steps, counted from 0: the second epoch's (the
        first's if there is no second) but its first and last, so that
        every traced step's rescale guard, which follows the step, falls
        inside the window and the epoch's end does not."""
        if self.n_batches < 3:
            raise RuntimeError(f"an epoch of {self.n_batches} steps has no steady steps")
        e = min(1, self.epochs - 1)
        return e * self.n_batches + 1, (e + 1) * self.n_batches - 2

    def traced(self) -> dict:
        """``RATE_FITS`` untraced fits timed on the host; then the steady run
        of steps, profiled from the start of its first step to the start
        of the step after its last, with the benchmark's spans and the
        optimizer's touches recorded.  Returns what the per-layer readers
        read."""
        torch = self.torch
        from lightfm_tpu_torch import fast_warp, losses

        t0 = time.perf_counter()
        for _ in range(RATE_FITS):
            self._fit()
        rate = RATE_FITS * self.epochs * self.nnz / (time.perf_counter() - t0)

        first, last = self._steady_steps()
        prof = traced.Profiler(torch, self.device)
        touches = []

        def record(update):
            def inner(table, acc, mom, idx, w, g, mask, *a, **k):
                if prof.active:
                    touches.append((idx, mask))
                return update(table, acc, mom, idx, w, g, mask, *a, **k)
            return inner

        def window(step):
            return _ahead_of({first: prof.start, last + 1: prof.stop})(
                traced.spanned(torch, "step", step))

        targets = [(fast_warp, "_unpack_batch5", "unpack"),
                   (losses, "_run_updates", "updates")]
        with traced.Patches() as p, wrapped_step(window):
            traced.span_all(torch, p, targets)
            p.wrap(losses, "sparse_update", record)
            self._fit()
        if prof.trace is None:
            raise RuntimeError(f"the traced fit did not reach step {last + 2}")
        # The optimizer passes' active touches (padding and examples that do
        # not update left out) and the distinct rows they touch, counted
        # after the window so that no counting runs inside it.
        active = [idx[mask.bool()] for idx, mask in touches]
        del touches
        m = self.cfg["model"]
        K = m["max_sampled"]
        self._check_fit()
        return {
            "trace": prof.trace, "fits": RATE_FITS + 2, "steps": last + 1 - first,
            "examples_per_s": rate,
            "flops_per_example": work_hybrid.example_flops(
                self.D, K, self.t_pos, self.t_neg, m.get("item_alpha", 0.0) != 0.0,
                m.get("user_alpha", 0.0) != 0.0),
            "score_bound_s": work_hybrid.score_bound_s(
                m["batch_size"], K, self.D, self.W, self.t_pos, self.t_neg,
                self.tags.shape[1]),
            "update_touches": sum(int(a.numel()) for a in active),
            "update_distinct": sum(int(torch.unique(a).numel()) for a in active),
            "table_width": self.W,
        }

    # -- check -------------------------------------------------------------

    def reference(self, rounding: str = "fp32") -> dict:
        """The plain reference's state before the checked fit's first step
        and after each of its first ``CHECK_STEPS`` steps, computed in
        ``rounding``."""
        if rounding not in self._refs:
            m = self.cfg["model"]
            self._refs[rounding] = warp_generic.first_steps(
                self.coo, self.tags, D=self.D, W=self.W, K=m["max_sampled"],
                lr=m["learning_rate"], item_alpha=m.get("item_alpha", 0.0),
                user_alpha=m.get("user_alpha", 0.0), batch_size=m["batch_size"],
                model_seed=self.model_seed, fits_before=self.fits_before,
                epochs=self.epochs, steps=range(CHECK_STEPS + 1), device=self.device,
                rounding=rounding)
        return self._refs[rounding]

    def compare(self, states: dict, ref: dict) -> dict:
        out = compare.fit_checks(states, ref, self.D, self.W, CHECK_STEPS)
        out["log_scale_gap"] = warp_generic.log_scale_gap(states, ref)
        return out

    def checks(self) -> dict:
        """The program's first steps against the plain reference's, and its
        end-of-epoch fold against the reference's fold of the same state."""
        want = warp_generic.fold(self.fold["before"], self.device)
        return dict(super().checks(),
                    fold_gap=warp_generic.fold_gap(self.fold["after"], want))

    def control(self) -> dict:
        """The reference in bfloat16 put in the program's place."""
        before = self.fold["before"]
        return dict(self.compare(self.reference("bf16"), self.reference()),
                    fold_gap=warp_generic.fold_gap(warp_generic.fold(before, self.device, "bf16"),
                                                   warp_generic.fold(before, self.device)))
