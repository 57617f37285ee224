"""Faults planted in the port's k-OS training under adadelta, to show that
the ``fit_partial`` cell's check catches them: the tests plant each on the
CPU, and ``portbench/readings_kos.py`` reads them on the card at the
cell's own size.

:func:`faulty_step` gives the generic k-OS step (``losses.LOSS_STEPS[
"warp-kos"]``, the step the generic epoch calls) with one of them:

- ``k1``: the k-OS step takes the best of the sampled positives, not the
  k-th (the step called with ``k = 1``).
- ``no_decay``: adadelta without ``rho``'s decay: ``ops.updates.scatter_mul``
  leaves the accumulator and the moment as they are (the L2 multiply of
  the table still runs).
- ``pre_acc``: ``lr_local`` from the accumulator before the step: the
  accumulator's decay and gain are held back until ``lr_local`` has been
  read, then applied.

:func:`in_checked_call` plants a fault in the first step of the cell's
checked call alone: a row's first touch finds a zero accumulator and
moment, where ``pre_acc`` takes ``lr_local = 1``, and the model diverges
within a few steps, which the program reports by raising in its finite
check; planted for longer, the fault would show as a failed run and not
in the compared numbers.
"""

from __future__ import annotations

import contextlib
import dataclasses

FAULTS = ("k1", "no_decay", "pre_acc")


@contextlib.contextmanager
def _scatters(make):
    """``losses.sparse_update`` with ``ops.updates.scatter_mul`` and
    ``scatter_add`` replaced, for the call, by ``make(acc, mom, mul, add)``."""
    from lightfm_tpu_torch import losses
    from lightfm_tpu_torch.ops import updates

    update = losses.sparse_update

    def faulty(table, acc, mom, *a, **kw):
        mul, add = updates.scatter_mul, updates.scatter_add
        updates.scatter_mul, updates.scatter_add = make(acc, mom, mul, add)
        try:
            return update(table, acc, mom, *a, **kw)
        finally:
            updates.scatter_mul, updates.scatter_add = mul, add

    losses.sparse_update = faulty
    try:
        yield
    finally:
        losses.sparse_update = update


def _no_decay(acc, mom, mul, add):
    def scatter_mul(target, rows, factors):
        if target is not acc and target is not mom:
            mul(target, rows, factors)
    return scatter_mul, add


def _pre_acc(acc, mom, mul, add):
    """Hold the accumulator's scatters back until the first scatter on the
    moment, which comes after ``lr_local`` is read."""
    held = []

    def release():
        for fn, args in held:
            fn(*args)
        held.clear()

    def scatter_mul(target, rows, factors):
        if target is acc:
            held.append((mul, (target, rows, factors)))
            return
        if target is mom:
            release()
        mul(target, rows, factors)

    def scatter_add(target, rows, values, *a):
        if target is acc:
            held.append((add, (target, rows, values, *a)))
            return
        release()
        add(target, rows, values, *a)

    return scatter_mul, scatter_add


def faulty_step(name: str, step):
    """The generic step ``step`` with fault ``name`` planted."""
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}")

    def inner(state, batch, user_feats, item_feats, positives, train_items, hp, *a, **kw):
        if name == "k1":
            return step(state, batch, user_feats, item_feats, positives, train_items,
                        dataclasses.replace(hp, k=1), *a, **kw)
        with _scatters(_no_decay if name == "no_decay" else _pre_acc):
            return step(state, batch, user_feats, item_feats, positives, train_items, hp,
                        *a, **kw)
    return inner


@contextlib.contextmanager
def in_checked_call(name: str):
    """Fault ``name`` planted in the first step of ``drivers/fit_partial.py``'s
    checked call (``Run._checked_call``) alone, for the body."""
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

        step = losses.LOSS_STEPS["warp-kos"]
        losses.LOSS_STEPS["warp-kos"] = first_faulty(step)
        try:
            check(self)
        finally:
            losses.LOSS_STEPS["warp-kos"] = step

    fit_partial.Run._checked_call = faulty
    try:
        yield
    finally:
        fit_partial.Run._checked_call = check
