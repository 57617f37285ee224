"""The BPR model of LightFM's learning-to-rank study (``loss="bpr"``,
``learning_schedule="adagrad"``, ``user_alpha`` and ``item_alpha``; upstream
``doc/examples/warp_loss.rst``) on the port's generic path, against the
benchmark's plain reference ``portbench/reference/bpr.py``, on the CPU at a
small size.

A ``fit`` or ``fit_partial`` of one epoch is watched through
``losses.LOSS_STEPS["bpr"]``; the reference makes each of its first three
steps from the state the program held before it, with the epoch's sort keys
and tries made again from the model's seed.  The picks (each example's
negative and whether it updates) are integer logic and agree exactly.
After each of the first three steps every field (tables, accumulators, both
log scales) agrees within ``1e-6`` of its largest magnitude: the two sum the
same float32 terms in another order (the reference sums each row's touches
in float64 and rounds once; the CPU path adds each touch to the
accumulator on its own, a rounding at the accumulator's magnitude each),
which moves an entry by at most 1.2e-7 of its field's largest here.  The
reference with its operands rounded to bfloat16, the precision below
float32, and each planted fault of ``portbench/faults_bpr.py`` fail it by
more than a hundred times.
"""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from lightfm_tpu_torch import LightFM, losses, observability

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from portbench import faults_bpr  # noqa: E402
from portbench.data import synth, zipf  # noqa: E402
from portbench.reference import bpr, warp_generic, warp_kos  # noqa: E402

B, SEED = 64, 11
N_USERS, N_ITEMS = 300, 200
# The tolerance of every field after each step, a share of its largest
# magnitude (see the module docstring).
TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _zipf():
    return zipf.zipf_interactions(N_USERS, N_ITEMS, 4000, 5)


def _fall_through():
    """The Zipf interactions with user 0's positives all items but the two
    least drawn, so that its tries are nearly all positives."""
    coo = _zipf()
    counts = np.bincount(coo.col, minlength=N_ITEMS)
    mine = np.sort(np.argsort(-counts, kind="stable")[:N_ITEMS - 2])
    keep = coo.row != 0
    rows = np.concatenate([np.zeros(mine.size, np.int32), coo.row[keep]])
    cols = np.concatenate([mine.astype(np.int32), coo.col[keep]])
    out = sp.coo_matrix((np.ones(rows.size, np.float32), (rows, cols)), shape=coo.shape)
    out.sum_duplicates()
    return out


DATA = {"zipf": _zipf, "fall_through": _fall_through}


def _model(D, alpha):
    return LightFM(loss="bpr", learning_schedule="adagrad", no_components=D, item_alpha=alpha,
                   user_alpha=alpha, batch_size=B, random_state=SEED, device="cpu")


def _watched_call(coo, calls, D, alpha, first_step=None, monkeypatch=None):
    """The calls ``calls`` on a fresh model, then one more ``fit_partial``
    watched: its state before its first step and after each of its first
    three, its first step's picks, its fold's sides and the epoch's seed.
    ``first_step(step)``: what runs in place of the first step."""
    model = _model(D, alpha)
    for kind in calls:
        getattr(model, kind)(coo, epochs=1)
    snaps, picks, fold, count = {}, {}, {}, [0]
    step = losses.LOSS_STEPS["bpr"]
    n_steps = -(-coo.nnz // B)

    def snapshot(state, fields=warp_kos.FIELDS):
        return {f: getattr(state, f).detach().clone() for f in fields}

    def watch(state, *a, **kw):
        # What step i receives: step i - 1's state after its rescale guard.
        if count[0] <= 3:
            snaps[count[0]] = snapshot(state)
        run = first_step(step) if first_step and count[0] == 0 else step
        out = run(state, *a, **kw)
        count[0] += 1
        if count[0] == n_steps:
            fold["before"] = snapshot(out, warp_generic.FOLD_FIELDS)
        return out

    def grab(state, hp, uf, itf, uid, pos_id, neg_id, *rest):
        if not picks:
            picks.update(uid=uid.clone(), pos_id=pos_id.clone(), neg_id=neg_id.clone(),
                         upd=rest[4].clone())
        return apply(state, hp, uf, itf, uid, pos_id, neg_id, *rest)

    apply = losses._apply_pairwise
    monkeypatch.setitem(losses.LOSS_STEPS, "bpr", watch)
    monkeypatch.setattr(losses, "_apply_pairwise", grab)
    model.fit_partial(coo, epochs=1)
    monkeypatch.undo()
    assert model._staged_fast is False and sorted(snaps) == [0, 1, 2, 3]
    fold["after"] = snapshot(model._state, warp_generic.FOLD_FIELDS)
    return snaps, picks, fold, warp_kos.epoch_seed(SEED, calls)


def _reference(coo, snaps, seed, D, alpha, rounding="fp32"):
    return bpr.first_steps(coo, snaps, seed=seed, D=D, lr=0.05, item_alpha=alpha,
                           user_alpha=alpha, batch_size=B, steps=range(4), device="cpu",
                           rounding=rounding)


def _worst(prog, ref):
    """The largest ``max |prog - ref|`` of a field after a step, over the
    field's largest magnitude (the unused ``*_mom`` fields are 0 in both)."""
    return max(float((prog[s][f] - ref[s][f]).abs().max()) / max(float(ref[s][f].abs().max()),
                                                                 1e-30)
               for s in (1, 2, 3) for f in warp_kos.FIELDS)


# (data, calls before the watched one, D, alpha): a Zipf head; a user whose
# tries fall through; the published width (D = 32, table width 40) and alpha.
CASES = [("zipf", ["fit"], 10, 1e-2), ("fall_through", ["fit", "fit_partial"], 10, 1e-2),
         ("zipf", ["fit", "fit_partial", "fit_partial"], 32, 1e-5)]


@pytest.mark.parametrize("data,calls,D,alpha", CASES)
def test_bpr_adagrad_steps_match_the_plain_reference(data, calls, D, alpha, monkeypatch):
    coo = DATA[data]()
    snaps, picks, _, seed = _watched_call(coo, calls, D, alpha, monkeypatch=monkeypatch)
    ref = _reference(coo, snaps, seed, D, alpha)
    assert _worst(snaps, ref) <= TOL
    assert bpr.pick_mismatch(picks, ref["picks"]) == 0.0
    assert torch.equal(picks["pos_id"].long(), ref["picks"]["pos_id"])
    # The steps moved every table and accumulator, and both scales.
    for f in ("item_table", "item_acc", "user_table", "user_acc", "item_log_scale",
              "user_log_scale"):
        assert not torch.equal(snaps[3][f], snaps[0][f]), f
    # The control: bfloat16 operands in the program's place.
    assert _worst(_reference(coo, snaps, seed, D, alpha, "bf16"), ref) > 100 * TOL
    if data == "fall_through":
        # Some of user 0's examples found no negative in their tries and
        # took the last, one of its positives.
        pos0 = set(coo.col[coo.row == 0].tolist())
        fell = [b for b in range(B) if int(picks["uid"][b]) == 0 and bool(picks["upd"][b])
                and int(picks["neg_id"][b]) in pos0]
        assert fell and ref["tries"] == 64


def test_the_epochs_fold_matches_the_plain_reference(monkeypatch):
    coo = _zipf()
    _, _, fold, _ = _watched_call(coo, ["fit", "fit_partial"], 10, 1e-2,
                                  monkeypatch=monkeypatch)
    assert float(fold["before"]["item_log_scale"]) != 0.0
    assert warp_generic.fold_gap(fold["after"], warp_generic.fold(fold["before"], "cpu")) <= 1e-7
    assert warp_generic.fold_gap(fold["before"], warp_generic.fold(fold["before"], "cpu")) > 1e-4


@pytest.mark.parametrize("fault", faults_bpr.FAULTS)
def test_each_planted_fault_breaks_the_tolerance(fault, monkeypatch):
    coo = _zipf()
    snaps, picks, _, seed = _watched_call(
        coo, ["fit", "fit_partial"], 10, 1e-2,
        first_step=lambda step: faults_bpr.faulty_step(fault, step), monkeypatch=monkeypatch)
    ref = _reference(coo, snaps, seed, 10, 1e-2)
    assert _worst(snaps, ref) > 100 * TOL
    mismatch = bpr.pick_mismatch(picks, ref["picks"])
    if fault == "uniform":
        assert mismatch > 0.5
    elif fault == "no_positives_test":
        assert mismatch > 0.05
    else:
        assert mismatch == 0.0


def test_the_pick_and_the_tries_budget_are_marked_and_counted():
    coo = _zipf()
    model = _model(10, 1e-2)
    with observability.recording() as rec:
        model.fit(coo, epochs=2)
    steps = 2 * -(-coo.nnz // B)
    picks = rec.named("step.bpr")
    assert len(picks) == len(rec.named("step.score")) == steps
    assert {rec.spans[s.parent].name for s in picks} == {"step.score"}
    tries = rec.named("fit.bpr_tries")
    assert len(tries) == 1 and rec.spans[tries[0].parent].name == "fit.stage"
    assert rec.counters["bpr_draws"] == steps * B * model._staged_hp.bpr_tries
    # No other loss sizes tries or marks a BPR pick.
    with observability.recording() as rec:
        LightFM(loss="warp", batch_size=B, device="cpu").fit(coo, epochs=1)
    assert not rec.named("step.bpr") and not rec.named("fit.bpr_tries")
    assert "bpr_draws" not in rec.counters


@pytest.mark.parametrize("data", ["zipf", "fall_through", "clustered", "cell_shape"])
def test_the_references_tries_agree_with_the_programs_budget(data):
    if data == "clustered":
        coo = synth.clustered_interactions(3000, 8000, 60000, 7)[0]
    elif data == "cell_shape":
        # The cell's law at a fiftieth of its draws.
        coo = zipf.zipf_interactions(4000, 2000, 100000, 9)
    else:
        coo = DATA[data]()
    assert bpr.tries_for(coo) == LightFM._bpr_tries_for(coo)
