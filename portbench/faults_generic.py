"""Faults planted in the port's generic WARP training under a run, to show that
a generic fit cell's check catches them: the benchmark's tests plant each
on the CPU, and ``portbench/readings_generic.py`` reads them on the card
at the cell's own size.  Each but ``no_fold`` replaces
``losses.LOSS_STEPS["warp"]``, the step the generic epoch calls.

- ``unchanged``: a step that returns its state unchanged.
- ``half_batch``: half of every batch left out.
- ``no_l2``: the step's lazy-L2 scale bump skipped (both log scales kept
  as they came in).
- ``no_scale``: the representations read the tables without their lazy-L2
  scales (``losses._scales`` gives none inside the step).
- ``no_fold``: the end-of-epoch fold skipped (``train.fold_scales`` returns
  its state); the only fault here that does not replace the step.
"""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "no_l2", "no_scale", "no_fold")


def _fault(name: str, step):
    import torch

    if name == "unchanged":
        return lambda state, *a, **k: state
    if name == "half_batch":
        def half(state, batch, *a, **k):
            n = batch.valid.shape[0]
            keep = torch.arange(n, device=batch.valid.device) < n // 2
            return step(state, batch._replace(valid=batch.valid & keep), *a, **k)
        return half
    if name == "no_l2":
        def no_l2(state, *a, **k):
            out = step(state, *a, **k)
            return out._replace(item_log_scale=state.item_log_scale,
                                user_log_scale=state.user_log_scale)
        return no_l2
    if name == "no_scale":
        from lightfm_tpu_torch import losses

        def no_scale(*a, **k):
            scales = losses._scales
            losses._scales = lambda state, hp: (None, None)
            try:
                return step(*a, **k)
            finally:
                losses._scales = scales
        return no_scale
    raise ValueError(f"unknown fault {name!r}")


@contextlib.contextmanager
def planted(name: str):
    from portbench.drivers.fit_generic import wrapped_step

    if name == "no_fold":
        from lightfm_tpu_torch import train

        fold = train.fold_scales
        train.fold_scales = lambda state: state
        try:
            yield
        finally:
            train.fold_scales = fold
        return
    with wrapped_step(lambda step: _fault(name, step)):
        yield
