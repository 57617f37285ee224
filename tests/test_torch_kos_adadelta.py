"""LightFM's learning-schedules k-OS model (``loss="warp-kos"``,
``learning_schedule="adadelta"``, ``user_alpha`` and ``item_alpha``;
upstream ``doc/examples/learning_schedules.rst``) on the port's generic
path, against the benchmark's plain reference
``portbench/reference/warp_kos.py``, and the port's ``recommend`` against
``portbench/reference/topk.py``, on the CPU at a small size.

A ``fit`` or ``fit_partial`` of one epoch is watched through
``losses.LOSS_STEPS["warp-kos"]``; the reference makes each of its first
three steps from the state the program held before it, with the epoch's
draws made again from the model's seed.  After each of the first three steps every
field (tables, accumulators, moments, both log scales) agrees within
``1e-6`` of its largest magnitude: the two sum the same float32 terms in
another order (the reference sums each row's touches in float64 and
rounds once, and takes ``lr_local`` as a quotient where the program
multiplies by a reciprocal square root), which moves an entry by at most
1.5e-7 of its field's largest here.  The reference with its operands
rounded to bfloat16, the precision below float32, and each planted fault
of ``portbench/faults_kos.py`` fail it by more than a hundred times.
"""

import os
import sys

import numpy as np
import pytest
import torch

from lightfm_tpu_torch import LightFM, losses, observability
from lightfm_tpu_torch.state import ModelState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from portbench import faults_kos  # noqa: E402
from portbench.data import synth  # noqa: E402
from portbench.reference import topk, warp_kos  # noqa: E402

D, W, K, N, KOS_K, B, SEED = 30, 32, 10, 10, 5, 64, 11
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


@pytest.fixture(scope="module")
def coo():
    return synth.clustered_interactions(N_USERS, N_ITEMS, 4000, 5, 4)[0]


def _model(alpha=1e-3):
    return LightFM(loss="warp-kos", learning_schedule="adadelta", no_components=D, k=KOS_K,
                   n=N, max_sampled=K, item_alpha=alpha, user_alpha=alpha, batch_size=B,
                   random_state=SEED, device="cpu")


def _watched_call(coo, calls, alpha=1e-3, first_step=None, monkeypatch=None):
    """The calls ``calls`` on a fresh model, then one more ``fit_partial``
    watched: its state before its first step and after each of its first
    three, its first step's picks, its fold's sides and the epoch's seed.
    ``first_step(step)``: what runs in place of the first step."""
    model = _model(alpha)
    for kind in calls:
        getattr(model, kind)(coo, epochs=1)
    snaps, picks, fold, count = {}, {}, {}, [0]
    step = losses.LOSS_STEPS["warp-kos"]
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
            fold["before"] = snapshot(out, warp_kos.FOLD_FIELDS)
        return out

    def grab(state, hp, uf, itf, uid, pos_id, neg_id, *rest):
        if not picks:
            picks.update(pos_id=pos_id.clone(), neg_id=neg_id.clone(), upd=rest[4].clone())
        return apply(state, hp, uf, itf, uid, pos_id, neg_id, *rest)

    apply = losses._apply_pairwise
    monkeypatch.setitem(losses.LOSS_STEPS, "warp-kos", watch)
    monkeypatch.setattr(losses, "_apply_pairwise", grab)
    model.fit_partial(coo, epochs=1)
    monkeypatch.undo()
    assert model._staged_fast is False and sorted(snaps) == [0, 1, 2, 3]
    fold["after"] = snapshot(model._state, warp_kos.FOLD_FIELDS)
    return snaps, picks, fold, warp_kos.epoch_seed(SEED, calls)


def _reference(coo, snaps, seed, alpha=1e-3, rounding="fp32"):
    return warp_kos.first_steps(coo, snaps, seed=seed, D=D, K=K, k=KOS_K, n=N, rho=0.95,
                                eps=1e-6, item_alpha=alpha, user_alpha=alpha, batch_size=B,
                                steps=range(4), device="cpu", rounding=rounding)


def _worst(prog, ref):
    """The largest ``max |prog - ref|`` of a field after a step, over the
    field's largest magnitude."""
    return max(float((prog[s][f] - ref[s][f]).abs().max()) / max(float(ref[s][f].abs().max()),
                                                                 1e-30)
               for s in (1, 2, 3) for f in warp_kos.FIELDS)


CASES = [(["fit"], 1e-3), (["fit", "fit_partial", "fit_partial"], 1e-3), (["fit"], 1e-2)]


@pytest.mark.parametrize("calls,alpha", CASES)
def test_kos_adadelta_steps_match_the_plain_reference(coo, calls, alpha, monkeypatch):
    snaps, picks, _, seed = _watched_call(coo, calls, alpha, monkeypatch=monkeypatch)
    ref = _reference(coo, snaps, seed, alpha)
    assert _worst(snaps, ref) <= TOL
    assert warp_kos.pick_mismatch(picks, ref["picks"]) == 0.0
    # The steps moved every table, accumulator and moment, and both scales.
    for f in warp_kos.FIELDS:
        assert not torch.equal(snaps[3][f], snaps[0][f]), f
    assert float(snaps[1]["item_log_scale"]) > float(snaps[0]["item_log_scale"])
    # The control: bfloat16 operands in the program's place.
    assert _worst(_reference(coo, snaps, seed, alpha, "bf16"), ref) > 100 * TOL


def test_the_epochs_fold_matches_the_plain_reference(coo, monkeypatch):
    _, _, fold, _ = _watched_call(coo, ["fit", "fit_partial"], monkeypatch=monkeypatch)
    assert float(fold["before"]["item_log_scale"]) != 0.0
    assert warp_kos.fold_gap(fold["after"], warp_kos.fold(fold["before"], "cpu")) <= 1e-7
    assert warp_kos.fold_gap(fold["before"], warp_kos.fold(fold["before"], "cpu")) > 1e-4


@pytest.mark.parametrize("fault", faults_kos.FAULTS)
def test_each_planted_fault_breaks_the_tolerance(coo, fault, monkeypatch):
    snaps, picks, _, seed = _watched_call(
        coo, ["fit", "fit_partial"], first_step=lambda step: faults_kos.faulty_step(fault, step),
        monkeypatch=monkeypatch)
    ref = _reference(coo, snaps, seed)
    assert _worst(snaps, ref) > 100 * TOL
    mismatch = warp_kos.pick_mismatch(picks, ref["picks"])
    assert (mismatch > 0.5) if fault == "k1" else (mismatch == 0.0)


def test_the_epoch_seed_follows_the_models_random_state(coo):
    model = _model()
    model.fit(coo, epochs=1)
    model.fit_partial(coo, epochs=1)
    rs = np.random.RandomState(SEED)
    top = np.iinfo(np.int32).max
    rs.randint(0, top)
    for _ in range(2):
        rs.randint(0, top, size=1)
    # fit: the state's seed and one epoch's; fit_partial: one epoch's.
    assert model.random_state.randint(0, top) == rs.randint(0, top)
    assert warp_kos.epoch_seed(SEED, ["fit", "fit_partial"]) != warp_kos.epoch_seed(SEED, ["fit"])


def test_the_kos_pick_is_marked_inside_the_score_and_counts_its_draws(coo):
    model = _model()
    with observability.recording() as rec:
        model.fit(coo, epochs=2)
    steps = 2 * -(-coo.nnz // B)
    kos = rec.named("step.kos")
    assert len(kos) == len(rec.named("step.score")) == steps
    assert {rec.spans[s.parent].name for s in kos} == {"step.score"}
    assert rec.counters["kos_draws"] == steps * N * B


def _served_model(n_users, n_items, seed):
    coo, cluster = synth.clustered_interactions(n_users, n_items, 20 * n_users, seed, 8)
    user, item = synth.planted_tables(torch, n_users, n_items, D, W, cluster, 8, seed + 1,
                                      torch.device("cpu"))
    model = LightFM(no_components=D, device="cpu")
    zero = torch.zeros(())
    model._state = ModelState(item, torch.ones_like(item), torch.zeros_like(item), user,
                              torch.ones_like(user), torch.zeros_like(user), zero, zero.clone())
    model.n_users_, model.n_items_ = coo.shape
    return model, coo.tocsr(), user, item


def test_recommend_matches_the_plain_top_k(monkeypatch):
    model, train, user, item = _served_model(400, 3000, 21)
    users = np.random.RandomState(3).choice(400, 128, replace=False).astype(np.int32)
    scores, ids = model.recommend(users, k=100, train_interactions=train)
    assert ids.shape == scores.shape == (128, 100)
    got = topk.check(user, item, train, users, scores, ids, D)
    assert got["topk_outside_band"] == 0 and got["topk_score_gap"] <= 1e-5
    # The control: TF32 operands in the program's place.
    control = topk.check(user, item, train, users,
                         *topk.top_k_tf32(user, item, train, users, 100), D)
    assert control["topk_score_gap"] > 1e-5
    # A returned train positive is outside the band.
    bad = ids.copy()
    bad[0, -1] = train[users[0]].indices[0]
    assert topk.check(user, item, train, users, scores, bad, D)["topk_outside_band"] >= 1
