"""Training traffic of one-epoch calls: a closed loop of
``LightFM.fit_partial(train, epochs=E)`` on one model, every
``calls_per_study``-th call a ``fit(train, epochs=E)`` that starts the
model afresh, so it never trains past the study's epochs (``E`` and the
study's length from the configuration's ``fit``).

Set-up makes the interactions from the seed, builds the model and makes
one warm call (a ``fit``), which must train on the generic path
(``_staged_fast`` False) and mark the parts of its step
(``fit_generic.GENERIC_SPANS``).  Every call stages the interactions again
and checks the state is finite, as a user's loop of ``fit_partial`` pays
it.  The window then calls back to back; a call starts only while the
window has room for one as long as the last.  ``train_examples_per_s`` is
the interactions of the calls that finished in the window over the time
from the window's start to the end of the last of them.

After the window, outside its time, one more ``fit_partial`` (after the
``fit`` that starts a study, where one is due) is watched through
``losses.LOSS_STEPS[loss]``: its state before its first step and after
each of its first ``CHECK_STEPS`` steps and their rescale guards (tables,
accumulators, moments and both log scales, as the next step receives
them), its first step's picks (each example's positive and violator, as
handed to ``losses._apply_pairwise``), and its tables and log scales
before and after the end-of-epoch fold.  The reference
(``portbench/reference/warp_kos.py``) makes each of those steps from the
kept state before it, with the epoch's draws made again from the model's
seed.
"""

from __future__ import annotations

import contextlib
import time

from portbench import traced, work_kos
from portbench.data import synth
from portbench.drivers import fit, fit_generic
from portbench.reference import warp_generic, warp_kos

CHECK_STEPS = fit.CHECK_STEPS
# Untraced calls a traced run times for the rate that ``mfu.fit`` reads.
RATE_CALLS = 10


class Run(fit.Run):
    """``drivers/fit.py``'s window and release over one-epoch calls."""

    def __init__(self, cell, seed: int, device):
        import torch

        self.torch = torch
        self.cfg = cell.config
        self.seed = seed
        self.device = device
        f, m = self.cfg["fit"], self.cfg["model"]
        self.epochs = int(f["epochs_per_call"])
        self.study = int(f["calls_per_study"])
        self.loss = m["loss"]
        self.D = m["no_components"]
        self.W = ((self.D + 1 + 7) // 8) * 8
        self.calls = []  # "fit" or "fit_partial", one a call made on the model
        self._refs = {}

    @contextlib.contextmanager
    def _wrapped_step(self, make):
        """``losses.LOSS_STEPS[loss]`` replaced by ``make(step)`` in the body."""
        from lightfm_tpu_torch import losses

        step = losses.LOSS_STEPS[self.loss]
        losses.LOSS_STEPS[self.loss] = make(step)
        try:
            yield
        finally:
            losses.LOSS_STEPS[self.loss] = step

    # -- set-up --------------------------------------------------------

    def _fit(self):
        kind = "fit" if len(self.calls) % self.study == 0 else "fit_partial"
        getattr(self.model, kind)(self.coo, epochs=self.epochs)
        self.calls.append(kind)

    def setup(self):
        from lightfm_tpu_torch import LightFM, observability

        d, m = self.cfg["data"], self.cfg["model"]
        self.coo, _ = synth.clustered_interactions(
            d["users"], d["items"], d["draws"], synth.sub_seed(self.seed, "interactions"),
            d["clusters"])
        self.model_seed = synth.sub_seed(self.seed, "model")
        self.model = LightFM(**m, random_state=self.model_seed, device=self.device)
        with observability.recording() as rec:
            self._fit()
        if self.model._staged_fast is not False:
            raise RuntimeError("the warm call did not train on the generic path")
        spans = fit_generic.GENERIC_SPANS
        if not any(rec.named(n) for n in spans):
            raise RuntimeError(f"the program marks none of {spans} in its generic epoch, so "
                               "this cell's per-layer metrics cannot be read on it")
        self.nnz = self.coo.nnz
        self.n_batches = (self.model._staged_train_data.packed.shape[1]
                          // self.model._staged_batch_size)

    # -- window (``fit.Run.window``) ----------------------------------------

    def _check_fit(self):
        """The ``fit`` that starts a study where one is due, then the
        checked call."""
        while len(self.calls) % self.study == 0:
            self._fit()
        self._checked_call()

    def _checked_call(self):
        """One ``fit_partial`` whose state before its first step and after
        each of its first ``CHECK_STEPS`` steps (each with its guard), first
        step's picks and fold are kept (on the host) for the check."""
        from lightfm_tpu_torch import losses

        snaps, fold, picks, count = {}, {}, {}, [0]
        n = self.n_batches

        def snapshot(state, fields=warp_kos.FIELDS):
            return {k: getattr(state, k).detach().to("cpu", copy=True) for k in fields}

        def watch(step):
            def inner(state, *args, **kwargs):
                # The state step i starts from is step i - 1's after its
                # rescale guard, which the epoch runs after the step.
                if count[0] <= CHECK_STEPS:
                    snaps[count[0]] = snapshot(state)
                out = step(state, *args, **kwargs)
                count[0] += 1
                if count[0] == n:
                    fold["before"] = snapshot(out, warp_kos.FOLD_FIELDS)
                return out
            return inner

        def grab(apply):
            def inner(*args, **kwargs):
                if not picks:
                    pos_id, neg_id, upd = args[5], args[6], args[11]
                    picks.update(pos_id=pos_id.cpu(), neg_id=neg_id.cpu(), upd=upd.cpu())
                return apply(*args, **kwargs)
            return inner

        self.calls_before = list(self.calls)
        with traced.Patches() as p, self._wrapped_step(watch):
            p.wrap(losses, "_apply_pairwise", grab)
            self._fit()
        if sorted(snaps) != list(range(CHECK_STEPS + 1)) or not fold or not picks:
            raise RuntimeError(f"the checked call did not train on the generic {self.loss} "
                               f"step for {n} steps")
        fold["after"] = snapshot(self.model._state, warp_kos.FOLD_FIELDS)
        self.snaps, self.fold, self.picks = snaps, fold, picks

    # -- traced window ---------------------------------------------------

    def traced(self) -> dict:
        """``RATE_CALLS`` untraced calls timed on the host; then the steady
        run of one call's steps (all but its first and last, so that every
        traced step's rescale guard falls inside the window and the
        epoch's end does not), profiled with the optimizer's touches
        recorded.  Returns what the per-layer readers read."""
        torch = self.torch
        from lightfm_tpu_torch import fast_warp, losses

        calls = len(self.calls)
        t0 = time.perf_counter()
        for _ in range(RATE_CALLS):
            self._fit()
        rate = RATE_CALLS * self.epochs * self.nnz / (time.perf_counter() - t0)

        if self.n_batches < 3:
            raise RuntimeError(f"an epoch of {self.n_batches} steps has no steady steps")
        first, last = 1, self.n_batches - 2
        while len(self.calls) % self.study == 0:
            self._fit()
        prof = traced.Profiler(torch, self.device)
        touches = []

        def record(update):
            def inner(table, acc, mom, idx, w, g, mask, *a, **k):
                if prof.active:
                    touches.append((idx, mask))
                return update(table, acc, mom, idx, w, g, mask, *a, **k)
            return inner

        def window(step):
            return fit_generic._ahead_of({first: prof.start, last + 1: prof.stop})(
                traced.spanned(torch, "step", step))

        targets = [(fast_warp, "_unpack_batch5", "unpack"),
                   (losses, "_run_updates", "updates")]
        with traced.Patches() as p, self._wrapped_step(window):
            traced.span_all(torch, p, targets)
            p.wrap(losses, "sparse_update", record)
            self._fit()
        if prof.trace is None:
            raise RuntimeError(f"the traced call did not reach step {last + 2}")
        # Counted after the window, so that no counting runs inside it.
        active = [idx[mask.bool()] for idx, mask in touches]
        del touches
        m = self.cfg["model"]
        self._check_fit()
        return {
            "trace": prof.trace, "fits": len(self.calls) - calls, "steps": last + 1 - first,
            "examples_per_s": rate,
            "flops_per_example": work_kos.flops_per_example(self.D, m["max_sampled"], m["n"]),
            "update_touches": sum(int(a.numel()) for a in active),
            "update_distinct": sum(int(torch.unique(a).numel()) for a in active),
            "table_width": self.W,
        }

    # -- check -------------------------------------------------------------

    def reference(self, rounding: str = "fp32") -> dict:
        """The plain reference's state after each of the checked call's
        first ``CHECK_STEPS`` steps, each from the kept state before it, in
        ``rounding``."""
        if rounding not in self._refs:
            m = self.cfg["model"]
            self._refs[rounding] = warp_kos.first_steps(
                self.coo, self.snaps,
                seed=warp_kos.epoch_seed(self.model_seed, self.calls_before), D=self.D,
                K=m["max_sampled"], k=m["k"], n=m["n"], rho=m["rho"], eps=m["epsilon"],
                item_alpha=m["item_alpha"], user_alpha=m["user_alpha"],
                batch_size=m["batch_size"], steps=range(CHECK_STEPS + 1), device=self.device,
                rounding=rounding)
        return self._refs[rounding]

    def compare(self, states: dict, picks: dict, fold_after: dict, ref: dict) -> dict:
        return {
            "change1_norm_gap": warp_kos.change_gap(states, ref, self.D, self.W),
            "log_scale_gap": warp_generic.log_scale_gap(
                states, {s: ref[s] for s in range(CHECK_STEPS + 1)}),
            "fold_gap": warp_kos.fold_gap(fold_after,
                                          warp_kos.fold(self.fold["before"], self.device)),
            "kos_pick_mismatch": warp_kos.pick_mismatch(picks, ref["picks"]),
        }

    def checks(self) -> dict:
        """The program's first steps, picks and fold against the plain
        reference's."""
        return self.compare(self.snaps, self.picks, self.fold["after"], self.reference())

    def control(self) -> dict:
        """The reference in bfloat16 put in the program's place."""
        low = self.reference("bf16")
        return self.compare(low, low["picks"],
                            warp_kos.fold(self.fold["before"], self.device, "bf16"),
                            self.reference())
