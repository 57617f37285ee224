"""BPR training traffic of one-epoch calls: ``drivers/fit_partial.py``'s
closed loop of ``LightFM.fit_partial(train, epochs=E)`` on one model, every
``calls_per_study``-th call a ``fit(train, epochs=E)``, on popularity-skewed
interactions (``data/zipf.py``), checked against the plain BPR reference
(``portbench/reference/bpr.py``).

Every call stages the interactions again, checks the state is finite and
sizes BPR's tries from the interactions, as a user's loop of
``fit_partial`` pays them.  Set-up requires of the program only what the
parent driver does (the generic path and its step's parts): the BPR spans
``step.bpr`` and ``fit.bpr_tries`` and the counter ``bpr_draws`` are read
where the program marks them, and their readers give nothing where it
does not.

The traced run first makes ``TRIES_CALLS`` calls under
``observability.recording()`` and keeps the host time of each of their
``fit.bpr_tries`` spans (staging, where the tries are sized, lies outside
the profiled steps), then runs the parent driver's traced window.

The checked call is the parent driver's (its state before its first step
and after each of its first ``CHECK_STEPS`` steps, its first step's picks
and its fold); the reference makes each of its first steps from the kept
state before it, with the epoch's sort keys and tries made again from the
model's seed.
"""

from __future__ import annotations

from portbench import work_bpr
from portbench.data import synth, zipf
from portbench.drivers import fit_generic, fit_partial
from portbench.reference import bpr, warp_generic, warp_kos

CHECK_STEPS = fit_partial.CHECK_STEPS
# Calls a traced run records for ``bpr_tries_ms.fit``.
TRIES_CALLS = 3


class Run(fit_partial.Run):
    """``drivers/fit_partial.py``'s run on BPR over Zipf interactions."""

    def setup(self):
        from lightfm_tpu_torch import LightFM, observability

        d, m = self.cfg["data"], self.cfg["model"]
        self.coo = zipf.zipf_interactions(d["users"], d["items"], d["draws"],
                                          synth.sub_seed(self.seed, "interactions"), d["zipf_s"])
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

    def traced(self) -> dict:
        """``TRIES_CALLS`` recorded calls, then the parent driver's traced
        window, with BPR's FLOPs an example for ``mfu.fit``."""
        from lightfm_tpu_torch import observability

        with observability.recording() as rec:
            for _ in range(TRIES_CALLS):
                self._fit()
        ctx = super().traced()
        ctx["fits"] += TRIES_CALLS
        ctx["bpr_tries_ns"] = [s.end_ns - s.start_ns for s in rec.named("fit.bpr_tries")]
        ctx["flops_per_example"] = work_bpr.flops_per_example(self.D)
        return ctx

    # -- check -------------------------------------------------------------

    def reference(self, rounding: str = "fp32") -> dict:
        """The plain reference's state after each of the checked call's
        first ``CHECK_STEPS`` steps, each from the kept state before it, in
        ``rounding``."""
        if rounding not in self._refs:
            m = self.cfg["model"]
            self._refs[rounding] = bpr.first_steps(
                self.coo, self.snaps,
                seed=warp_kos.epoch_seed(self.model_seed, self.calls_before), D=self.D,
                lr=m["learning_rate"], item_alpha=m["item_alpha"], user_alpha=m["user_alpha"],
                batch_size=m["batch_size"], steps=range(CHECK_STEPS + 1), device=self.device,
                rounding=rounding)
        return self._refs[rounding]

    def compare(self, states: dict, picks: dict, fold_after: dict, ref: dict) -> dict:
        return {
            "change1_norm_gap": bpr.change_gap(states, ref, self.D, self.W),
            "log_scale_gap": warp_generic.log_scale_gap(
                states, {s: ref[s] for s in range(CHECK_STEPS + 1)}),
            "fold_gap": warp_generic.fold_gap(
                fold_after, warp_generic.fold(self.fold["before"], self.device)),
            "bpr_pick_mismatch": bpr.pick_mismatch(picks, ref["picks"]),
        }

    def control(self) -> dict:
        """The reference in bfloat16 put in the program's place."""
        low = self.reference("bf16")
        return self.compare(low, low["picks"],
                            warp_generic.fold(self.fold["before"], self.device, "bf16"),
                            self.reference())
