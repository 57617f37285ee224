"""The generic step's scoring of identity rows (``ops/feature_sums.py``'s
``identity_scores``), held on the CPU: its plain version against the
composition it replaced, its argument checks, ``candidate_scores``' dispatch,
and the k-OS and BPR steps' state through it.  The ``card`` tests hold the
kernel against the plain version on the card, at the k-OS and BPR cells'
shapes and at edges, and count its launches in one k-OS step.

This module imports no JAX, so the card tests run on a machine without it:
``python -m pytest tests/test_torch_identity_scores.py -m card --noconftest``.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from lightfm_tpu_torch import config, interop, losses, observability, sparse, train
from lightfm_tpu_torch.fast_warp import _unpack_batch5
from lightfm_tpu_torch.ops import feature_sums as fs
from lightfm_tpu_torch.ops import representation as rep
from lightfm_tpu_torch.state import table_width

N_ROWS, B = 70, 24
EPS = 2.0**-23  # one float32 ulp at 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _old_composition(table, ids, users, scale):
    """Identity candidates as the generic step scored them before
    ``identity_scores``: ``batch_representation``'s identity branch (the
    row gather, then the scale) and ``score_candidates``."""
    rows = table[ids.reshape(-1).long()]
    if scale is not None:
        rows = rows * scale
    C, (B_, W) = ids.shape[0], users.shape
    u1 = torch.cat([users[:, :-1], torch.ones_like(users[:, -1:])], dim=-1)
    return rows, (rows.view(C, B_, W) * u1[None, :, :]).sum(-1) + users[None, :, -1]


def _inputs(C, W, n_rows=N_ROWS, batch=B, seed=0, device="cpu"):
    """A table, users and slot-major int32 ids ``[C, batch]`` (repeats and
    the table's first and last rows among them)."""
    rng = np.random.RandomState(seed + 31 * C + W)
    table = torch.tensor(rng.randn(n_rows, W).astype(np.float32), device=device)
    users = torch.tensor(rng.randn(batch, W).astype(np.float32), device=device)
    ids = rng.randint(0, n_rows, (C, batch)).astype(np.int32)
    ids[0, :3] = [0, n_rows - 1, 0]
    return table, users, torch.tensor(ids, device=device)


SCALES = {"none": None, "number": 0.8125, "tensor": np.float32(1.0371094)}


def _scale(kind, device="cpu"):
    s = SCALES[kind]
    return torch.tensor(s, device=device) if kind == "tensor" else s


@pytest.mark.parametrize("C", [1, 2, 10, 11])
@pytest.mark.parametrize("W", [32, 33, 40, 66])
@pytest.mark.parametrize("scale", list(SCALES))
def test_plain_is_the_old_composition_bitwise(C, W, scale):
    table, users, ids = _inputs(C, W)
    s = _scale(scale)
    fs.reset_launches()
    reps, scores = fs.identity_scores(table, ids.reshape(-1), users, s)
    want_reps, want_scores = _old_composition(table, ids, users, s)
    assert reps.shape == (C * B, W) and scores.shape == (C, B)
    assert torch.equal(reps, want_reps) and torch.equal(scores, want_scores)
    got = rep.candidate_scores(table, sparse.identity_rows(N_ROWS), ids, users, s)
    assert torch.equal(got[0], want_reps) and torch.equal(got[1], want_scores)
    assert fs.launches == {"feature_sums": 0, "identity_scores": 0}


def _args():
    table, users, ids = _inputs(2, 16)
    return dict(table=table, ids=ids.reshape(-1), users=users,
                scale=torch.tensor(np.float32(0.5)))


def _noncontiguous(x):
    return x.t().contiguous().t() if x.dim() == 2 else torch.stack([x, x], 1)[:, 0]


BAD_ARGS = {
    "table f64": ("table", lambda a: a.double(), TypeError),
    "ids int64": ("ids", lambda a: a.long(), TypeError),
    "users f64": ("users", lambda a: a.double(), TypeError),
    "scale f64": ("scale", lambda a: a.double(), TypeError),
    "scale a list": ("scale", lambda a: [0.5], TypeError),
    "users not a tensor": ("users", lambda a: a.numpy(), TypeError),
    "ids on meta": ("ids", lambda a: a.to("meta"), ValueError),
    "users on meta": ("users", lambda a: a.to("meta"), ValueError),
    "scale on meta": ("scale", lambda a: a.to("meta"), ValueError),
    "ids 2-D": ("ids", lambda a: a.view(2, -1), ValueError),
    "users narrower than the table": ("users", lambda a: a[:, :8].contiguous(), ValueError),
    "ids not whole rows of users": ("ids", lambda a: a[:-1].contiguous(), ValueError),
    "table not contiguous": ("table", _noncontiguous, ValueError),
    "ids not contiguous": ("ids", _noncontiguous, ValueError),
    "users not contiguous": ("users", _noncontiguous, ValueError),
}


@pytest.mark.parametrize("case", list(BAD_ARGS))
def test_identity_scores_refuses_what_it_does_not_take(case):
    name, bad, error = BAD_ARGS[case]
    args = _args()
    fs.identity_scores(**args)  # the unaltered arguments are taken
    args[name] = bad(args[name])
    with pytest.raises(error):
        fs.identity_scores(**args)


def test_identity_scores_counts_no_launch_and_no_rows_on_the_cpu():
    fs.reset_launches()
    with observability.recording() as rec:
        fs.identity_scores(**_args())
    assert fs.launches == {"feature_sums": 0, "identity_scores": 0}
    assert [s.name for s in rec.spans] == ["kernel.identity_scores"]
    assert "identity_score_rows" not in rec.counters


class _WholeRows:
    """A placement that reads whole rows: only its presence differs from
    none."""

    def rows(self, table, ids):
        return table[ids]


def test_candidate_scores_dispatches_by_features_and_placement(monkeypatch):
    """Identity rows (or None) of a whole table go to ``identity_scores``,
    padded rows to ``feature_sums``, a placement to the rows' gather and
    ``score_candidates``; each gives the old composition's numbers."""
    table, users, ids = _inputs(3, 16)
    scale = torch.tensor(np.float32(0.75))
    calls = []
    for name in ("identity_scores", "feature_sums"):
        real = getattr(rep, name)
        monkeypatch.setattr(rep, name, lambda *a, _n=name, _f=real, **k:
                            calls.append(_n) or _f(*a, **k))
    want = _old_composition(table, ids, users, scale)
    for features, placement, route in (
        (sparse.identity_rows(N_ROWS), None, ["identity_scores"]),
        (None, None, ["identity_scores"]),
        (sparse.identity_rows(N_ROWS), _WholeRows(), []),
        (None, _WholeRows(), []),
    ):
        calls.clear()
        got = rep.candidate_scores(table, features, ids, users, scale, placement)
        assert calls == route
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    calls.clear()
    padded = sparse.PaddedRows(torch.arange(N_ROWS, dtype=torch.int32)[:, None],
                               torch.ones(N_ROWS, 1), N_ROWS)
    rep.candidate_scores(table, padded, ids, users, scale)
    assert calls == ["feature_sums"]


# ---------------------------------------------------------------------------
# The generic steps over identity items, against the old scoring
# ---------------------------------------------------------------------------

ST_USERS, ST_ITEMS, ST_B, ST_D = 90, 120, 64, 6


def _step_inputs(loss: str, alpha: float, device="cpu", n=6, K=10):
    """A generic step's inputs over identity users and items: interactions,
    a random state and the loss's draws (made with numpy, then moved)."""
    rng = np.random.RandomState(13)
    rows = np.repeat(np.arange(ST_USERS), 8)
    cols = rng.randint(0, ST_ITEMS, rows.size)
    coo = sp.coo_matrix((np.ones(rows.size, np.float32), (rows, cols)),
                        shape=(ST_USERS, ST_ITEMS))
    user_feats = sparse.identity_rows(ST_USERS)
    item_feats = sparse.identity_rows(ST_ITEMS)
    hp = config.Hyperparams(loss=loss, no_components=ST_D, item_alpha=alpha, user_alpha=alpha,
                            learning_rate=0.1, max_sampled=K, n=n, k=3, bpr_tries=8)
    data = train.build_train_data(coo, np.ones_like(coo.data), user_feats, item_feats, hp,
                                  ST_B, device)
    W = table_width(ST_D)
    arrays = {}
    for side, n_rows in (("item", ST_ITEMS), ("user", ST_USERS)):
        arrays[f"{side}_table"] = (0.3 * rng.randn(n_rows, W)).astype(np.float32)
        arrays[f"{side}_acc"] = (1 + rng.rand(n_rows, W)).astype(np.float32)
        arrays[f"{side}_mom"] = np.zeros((n_rows, W), np.float32)
    arrays["item_log_scale"] = np.float32(0.3 if alpha else 0.0)
    arrays["user_log_scale"] = np.float32(0.2 if alpha else 0.0)
    batch = _unpack_batch5(data.packed[:, :ST_B])
    if loss == "bpr":
        draws = torch.tensor(rng.randint(0, coo.nnz, (ST_B, hp.bpr_tries)), dtype=torch.int32,
                             device=device)
    else:
        lens = data.positives.lengths[batch.user_ids.long()].cpu()
        slots = losses.kos_slots(torch.tensor(rng.rand(hp.n, ST_B), dtype=torch.float32), lens)
        draws = (slots.to(device), torch.tensor(rng.randint(0, ST_ITEMS, (K, ST_B)),
                                                dtype=torch.int32, device=device))
    return arrays, batch, user_feats, item_feats, data, hp, draws


def _run_step(loss, arrays, batch, uf, itf, data, hp, draws, device="cpu"):
    return losses.LOSS_STEPS[loss](interop.state_from_numpy(arrays, device), batch, uf, itf,
                                   data.positives, data.train_items, hp, draws)


@pytest.mark.parametrize("loss, calls_per_step", [("warp-kos", 2), ("bpr", 1)])
@pytest.mark.parametrize("alpha", [0.0, 1e-3])
def test_steps_over_identity_items_keep_the_old_state(loss, calls_per_step, alpha, monkeypatch):
    """The k-OS step (its positives and its negatives) and the BPR step
    score their identity candidates through ``identity_scores`` and leave
    the state bitwise as the old composition does."""
    inputs = _step_inputs(loss, alpha)
    calls = []
    real = rep.identity_scores
    monkeypatch.setattr(rep, "identity_scores",
                        lambda *a, **k: calls.append(a[1].numel()) or real(*a, **k))
    got = _run_step(loss, *inputs)
    n_cands = {"warp-kos": [6 * ST_B, 10 * ST_B], "bpr": [2 * ST_B]}[loss]
    assert len(calls) == calls_per_step and calls == n_cands

    def old(table, features, ids, user_rep, scale=None, placement=None):
        assert placement is None and isinstance(features, sparse.IdentityRows)
        return _old_composition(table, ids, user_rep, scale)

    monkeypatch.setattr(losses, "candidate_scores", old)
    want = _run_step(loss, *inputs)
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert not torch.equal(got.item_table, torch.tensor(inputs[0]["item_table"]))


# -- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _score_bound(users, reps, C):
    """4 float32 ulps of each score's sum of |terms| (the dot's products,
    the item's and the user's bias)."""
    return 4 * EPS * rep.score_candidates(users.abs(), reps.abs(), C)


# name: (C, batch, W, table rows, scale kind, misaligned table)
CARD_CASES = {
    "k-OS step": (10, 131_072, 32, 100_000, "tensor", False),
    "BPR step": (2, 131_072, 40, 100_000, "tensor", False),
    "W=1": (3, 1_000, 1, 500, "number", False),
    "W=33": (11, 777, 33, 3_000, "none", False),
    "W=200": (5, 4_096, 200, 3_000, "tensor", False),
    "W=32 misaligned": (7, 4_099, 32, 3_000, "number", True),
    "C=40": (40, 513, 72, 2_000, "none", False),
}


@pytest.mark.card
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_kernel_matches_plain_on_the_card(card, name):
    """reps bitwise the plain version's, scores within 4 ulps of their
    sums of |terms|, two launches bitwise equal, one launch a call counted
    with its rows."""
    C, batch, W, R, scale_kind, misaligned = CARD_CASES[name]
    table, users, ids = _inputs(C, W, R, batch, device=card)
    if misaligned:
        flat = torch.empty(R * W + 1, device=card)
        flat[1:] = table.reshape(-1)
        table = flat[1:].view(R, W)
        assert table.data_ptr() % 16 != 0 and table.is_contiguous()
    s = _scale(scale_kind, card)
    flat_ids = ids.reshape(-1)
    fs.reset_launches()
    with observability.recording() as rec:
        reps, scores = fs.identity_scores(table, flat_ids, users, s)
        again, again_s = fs.identity_scores(table, flat_ids, users, s)
    torch.cuda.synchronize()
    assert fs.launches["identity_scores"] == 2
    assert rec.counters["identity_score_rows"] == 2 * C * batch
    assert torch.equal(reps, again) and torch.equal(scores, again_s)
    want_reps, want_scores = fs.identity_scores_plain(table, flat_ids, users, s)
    assert torch.equal(reps, want_reps)
    gap = (scores - want_scores).abs()
    assert bool((gap <= _score_bound(users, want_reps, C)).all()), float(gap.max())


@pytest.mark.card
@pytest.mark.parametrize("W", [32, 40, 33])
def test_kernel_is_the_padded_kernel_on_one_slot_rows(card, W):
    """On rows of one slot of weight 1 (feature = row), ``feature_sums``
    computes the same function; the two kernels take the dot's terms in the
    same order, so they agree bitwise."""
    C, batch, R = 10, 8_192, 5_000
    table, users, ids = _inputs(C, W, R, batch, device=card)
    idx = torch.arange(R, dtype=torch.int32, device=card)[:, None].contiguous()
    wts = torch.ones(R, 1, device=card)
    s = torch.tensor(np.float32(1.0371094), device=card)
    got = fs.identity_scores(table, ids.reshape(-1), users, s)
    want = fs.feature_sums(table, idx, wts, ids.reshape(-1), s, users)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.card
def test_out_of_range_ids_read_nan_on_the_card(card):
    C, batch, W, R = 4, 2_048, 32, 1_000
    table, users, ids = _inputs(C, W, R, batch, device=card)
    flat = ids.reshape(-1)
    bad = flat.clone()
    bad[:3] = torch.tensor([R, -1, 2**31 - 1], dtype=torch.int32, device=card)
    got, got_s = fs.identity_scores(table, bad, users, None)
    want, want_s = fs.identity_scores(table, flat, users, None)
    assert bool(torch.isnan(got[:3]).all() and torch.isnan(got_s.view(-1)[:3]).all())
    assert torch.equal(got[3:], want[3:])
    assert torch.equal(got_s.view(-1)[3:], want_s.view(-1)[3:])


@pytest.mark.card
def test_one_kos_step_launches_the_kernel_twice_on_the_card(card):
    """One k-OS step with n = K = 10 on the card: two launches inside
    ``step.score``, 20·B rows, and the state within float32 rounding of
    the CPU's step."""
    inputs = _step_inputs("warp-kos", 1e-3, device=card, n=10, K=10)
    fs.reset_launches()
    with observability.recording() as rec:
        got = _run_step("warp-kos", *inputs, device=card)
        torch.cuda.synchronize()
    assert fs.launches["identity_scores"] == 2
    assert rec.counters["identity_score_rows"] == 20 * ST_B
    spans = rec.named("kernel.identity_scores")
    assert len(spans) == 2

    def under_score(span):
        while span.parent is not None:
            span = rec.spans[span.parent]
            if span.name == "step.score":
                return True
        return False

    assert all(under_score(s) for s in spans)
    cpu = _step_inputs("warp-kos", 1e-3, n=10, K=10)
    want = _run_step("warp-kos", *cpu)
    for name in want._fields:
        np.testing.assert_allclose(getattr(got, name).cpu().numpy(),
                                   getattr(want, name).numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
