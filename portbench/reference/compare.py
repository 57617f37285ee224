"""The comparisons that decide whether a fit cell's first steps are
correct, by the worst leaf of the model's state.

Leaves are the column groups of the fused ``[n, W]`` tables: embeddings
(``:D``), padding (``D:W-1``) and bias (``W-1``), of the item and of the
user side.  A leaf whose reference gradient is under a thousandth of the
median leaf's is left out (padding never moves).
"""

from __future__ import annotations

import numpy as np
import torch


def leaves(D: int, W: int):
    return {"emb": slice(0, D), "pad": slice(D, W - 1), "bias": slice(W - 1, W)}


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def leaf_norms(before: dict, after: dict, D: int, W: int, what: str) -> dict:
    """Per leaf: ``"grad"`` the norm of the first gradient as adagrad got
    it, ``sqrt(sum(acc_after - acc_before))``; ``"change"`` the norm of
    ``table_after - table_before``."""
    out = {}
    for side in ("item", "user"):
        for name, cols in leaves(D, W).items():
            if what == "grad":
                d = after[f"{side}_acc"][:, cols] - before[f"{side}_acc"][:, cols]
                out[f"{side}_{name}"] = float(np.sqrt(max(float(d.double().sum()), 0.0)))
            else:
                d = after[f"{side}_table"][:, cols] - before[f"{side}_table"][:, cols]
                out[f"{side}_{name}"] = _norm(d)
    return out


def live_leaves(ref_grad: dict) -> list:
    med = float(np.median(list(ref_grad.values())))
    return [k for k, v in ref_grad.items() if v >= 1e-3 * med]


def worst_gap(prog: dict, ref: dict, live: list) -> float:
    """``max over live leaves of |prog - ref| / max(ref, median live ref)``."""
    med = float(np.median([ref[k] for k in live]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in live)


def fit_checks(prog: dict, ref: dict, D: int, W: int, last: int) -> dict:
    """The numbers a fit cell's limits may compare, of the program's
    snapshots ``prog`` against the reference's ``ref`` (``{step: tables}``):
    ``grad_norm_gap`` (the first gradient), ``change1_norm_gap`` (the change
    after the first step) and ``change_norm_gap`` (the change after step
    ``last``)."""
    ref_grad = leaf_norms(ref[0], ref[1], D, W, "grad")
    live = live_leaves(ref_grad)

    def change_gap(step):
        return worst_gap(leaf_norms(prog[0], prog[step], D, W, "change"),
                         leaf_norms(ref[0], ref[step], D, W, "change"), live)

    return {
        "grad_norm_gap": worst_gap(leaf_norms(prog[0], prog[1], D, W, "grad"), ref_grad, live),
        "change1_norm_gap": change_gap(1),
        "change_norm_gap": change_gap(last),
    }


def fit_detail(prog: dict, ref: dict, D: int, W: int) -> dict:
    """``{step: {leaf: gap}}``: each live leaf's gap of change norms after
    every step the snapshots hold, for looking into a reading."""
    live = live_leaves(leaf_norms(ref[0], ref[1], D, W, "grad"))
    out = {}
    for step in sorted(k for k in ref if k):
        p = leaf_norms(prog[0], prog[step], D, W, "change")
        r = leaf_norms(ref[0], ref[step], D, W, "change")
        med = float(np.median([r[k] for k in live]))
        out[step] = {k: abs(p[k] - r[k]) / max(r[k], med) for k in live}
    return out
