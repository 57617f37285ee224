"""Faults planted in the port's BPR training under adagrad, to show that the
``bpr-adagrad-l2.fit-partial`` cell's check catches them: the tests plant
each on the CPU, and ``portbench/readings_bpr.py`` reads them on the card
at the cell's own size.  Each is planted through what both the CPU and the
card's path call (the step's arguments, ``losses.in_positives`` and
``losses.sparse_update``), never through a scatter that only the CPU runs.

:func:`faulty_step` gives the generic BPR step (``losses.LOSS_STEPS["bpr"]``,
the step the generic epoch calls) with one of them:

- ``uniform``: negatives drawn uniformly over the catalog rather than by
  the items' empirical popularity: each try is taken modulo the item count
  as an item id.
- ``no_positives_test``: the tries are not tested against the user's
  positives, so the first try is always the negative.
- ``no_user_alpha``: ``user_alpha`` ignored: no L2 multiply of the user
  table and no bump of its scale.
- ``post_acc``: ``lr_local`` from the accumulator after the step: each
  table's pass is handed its accumulator with the step's summed squares
  already added, and the accumulator is left as the sound step leaves it.

:func:`in_checked_call` plants a fault in the first step of the cell's
checked call alone.
"""

from __future__ import annotations

import contextlib
import dataclasses

FAULTS = ("uniform", "no_positives_test", "no_user_alpha", "post_acc")


def _post_acc(update):
    def inner(table, acc, mom, idx, w, g, mask, *a, **kw):
        wg = (w * mask.to(w.dtype))[:, None] * g
        after = acc.clone().index_add_(0, idx.long(), wg * wg)
        out = update(table, after.clone(), mom, idx, w, g, mask, *a, **kw)
        acc.copy_(after)
        return (out[0], acc, *out[2:])
    return inner


def faulty_step(name: str, step):
    """The generic step ``step`` with fault ``name`` planted."""
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}")

    def inner(state, batch, user_feats, item_feats, positives, train_items, hp, draws, *a,
              **kw):
        import torch

        from lightfm_tpu_torch import losses

        if name == "uniform":
            n_items = item_feats.n_rows
            train_items = torch.arange(n_items, dtype=train_items.dtype,
                                       device=train_items.device)
            draws = draws % n_items
        elif name == "no_user_alpha":
            hp = dataclasses.replace(hp, user_alpha=0.0)
        saved = losses.in_positives, losses.sparse_update
        if name == "no_positives_test":
            losses.in_positives = lambda rows, row_ids, col_ids: torch.zeros_like(
                col_ids, dtype=torch.bool)
        elif name == "post_acc":
            losses.sparse_update = _post_acc(losses.sparse_update)
        try:
            return step(state, batch, user_feats, item_feats, positives, train_items, hp, draws,
                        *a, **kw)
        finally:
            losses.in_positives, losses.sparse_update = saved
    return inner


@contextlib.contextmanager
def in_checked_call(name: str):
    """Fault ``name`` planted in the first step of ``drivers/fit_partial.py``'s
    checked call (``Run._checked_call``, which ``drivers/fit_partial_bpr.py``
    inherits) alone, for the body."""
    from portbench.drivers import fit_partial

    check = fit_partial.Run._checked_call

    def first_faulty(step):
        done = [False]

        def inner(*a, **kw):
            if done[0]:
                return step(*a, **kw)
            done[0] = True
            return faulty_step(name, step)(*a, **kw)
        return inner

    def faulty(self):
        from lightfm_tpu_torch import losses

        step = losses.LOSS_STEPS["bpr"]
        losses.LOSS_STEPS["bpr"] = first_faulty(step)
        try:
            check(self)
        finally:
            losses.LOSS_STEPS["bpr"] = step

    fit_partial.Run._checked_call = faulty
    try:
        yield
    finally:
        fit_partial.Run._checked_call = check
