"""lightfm_tpu_torch.ops.representation vs lightfm_tpu.ops.representation,
on the CPU, for identity, padded and chunked features; the feature-sums
kernel's plain version (``ops/feature_sums.py``) against the composition it
replaced, its argument checks, and the generic steps' scoring through it."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from lightfm_tpu import sparse as jax_sparse
from lightfm_tpu.ops import representation as jax_rep

from lightfm_tpu_torch import config, interop, losses, observability, sparse, train
from lightfm_tpu_torch.fast_warp import _unpack_batch5
from lightfm_tpu_torch.ops import feature_sums as fs
from lightfm_tpu_torch.ops import representation as rep
from lightfm_tpu_torch.state import table_width

N_ROWS, N_FEATS, W = 50, 40, 16


def _features(kind):
    if kind == "identity":
        return sparse.identity_rows(N_ROWS), jax_sparse.identity_rows(N_ROWS)
    rng = np.random.RandomState(4)
    m = sp.random(N_ROWS, N_FEATS, density=0.08, random_state=rng, format="lil",
                  dtype=np.float32)
    m[np.arange(N_ROWS), np.arange(N_ROWS) % N_FEATS] = 1.0
    if kind == "chunked":
        m[9, :] = rng.rand(N_FEATS).astype(np.float32)
    kwargs = {"width_cap": 4, "chunk_width": 8} if kind == "chunked" else {"pad_multiple": 8}
    csr = m.tocsr()
    t, j = sparse.pad_csr(csr, **kwargs), jax_sparse.pad_csr(csr, **kwargs)
    assert type(t).__name__ == ("ChunkedRows" if kind == "chunked" else "PaddedRows")
    return t, j


def _table(n):
    return np.random.RandomState(1).randn(n, W).astype(np.float32)


@pytest.mark.parametrize("kind", ["identity", "padded", "chunked"])
@pytest.mark.parametrize("scaled", [False, True])
def test_batch_representation_matches_jax(kind, scaled):
    tf, jf = _features(kind)
    table = _table(N_ROWS if kind == "identity" else N_FEATS)
    ids = np.random.RandomState(2).randint(0, N_ROWS, (6, 5)).astype(np.int32)
    scale = np.float32(0.5) if scaled else None
    got = rep.batch_representation(
        torch.tensor(table), tf, torch.tensor(ids),
        None if scale is None else torch.tensor(scale),
    )
    want = jax_rep.batch_representation(
        jnp.asarray(table), jf, jnp.asarray(ids), None if scale is None else jnp.float32(scale)
    )
    assert tuple(got.shape) == (6, 5, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["identity", "padded", "chunked"])
def test_full_representations_matches_jax(kind):
    tf, jf = _features(kind)
    table = _table(N_ROWS if kind == "identity" else N_FEATS)
    # block=16 walks several row blocks, as a large catalog does.
    got = rep.full_representations(torch.tensor(table), tf, block=16)
    want = jax_rep.full_representations(jnp.asarray(table), jf, block=16)
    assert tuple(got.shape) == (N_ROWS, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_score_pairs_and_unit_bias_match_jax():
    rng = np.random.RandomState(5)
    u = rng.randn(30, W).astype(np.float32)
    i = rng.randn(30, W).astype(np.float32)
    np.testing.assert_array_equal(
        rep.with_unit_bias(torch.tensor(u)).numpy(),
        np.asarray(jax_rep.with_unit_bias(jnp.asarray(u))),
    )
    got = rep.score_pairs(torch.tensor(u), torch.tensor(i)).numpy()
    want = np.asarray(jax_rep.score_pairs(jnp.asarray(u), jnp.asarray(i)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    exact = (u[:, :-1].astype(np.float64) * i[:, :-1]).sum(1) + u[:, -1] + i[:, -1]
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-5)


def test_f32_dot_is_a_plain_matmul_on_the_cpu():
    a, b = torch.randn(4, 9), torch.randn(9, 3)
    assert torch.equal(rep.f32_dot(a, b), a @ b)


@pytest.mark.parametrize("kind", ["padded", "chunked"])
def test_feature_reductions_ignore_a_global_tf32_flag(kind, monkeypatch):
    """Padded and chunked reductions are IEEE fp32 matmuls through f32_dot,
    so turning TF32 on globally changes neither result nor the flag."""
    tf, _ = _features(kind)
    table = torch.tensor(_table(N_FEATS))
    ids = torch.tensor(np.random.RandomState(2).randint(0, N_ROWS, (6, 5)))
    flags = torch.backends.cuda.matmul
    monkeypatch.setattr(flags, "allow_tf32", False)
    want = rep.batch_representation(table, tf, ids), rep.full_representations(table, tf)

    calls = []
    f32_dot = rep.f32_dot
    monkeypatch.setattr(rep, "f32_dot", lambda a, b: calls.append(1) or f32_dot(a, b))
    monkeypatch.setattr(flags, "allow_tf32", True)
    got = rep.batch_representation(table, tf, ids), rep.full_representations(table, tf)
    assert calls, "feature reductions bypassed f32_dot"
    assert flags.allow_tf32
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# feature_sums: the plain version against the composition it replaced
# ---------------------------------------------------------------------------

FS_ROWS, FS_FEATS, FS_B = 60, 50, 24


def _padded_rows(P: int, seed: int = 7):
    """Padded rows of width ``P``: 0 to P real features a row (rows 3, 17
    and 40 all padding), weights in [0.25, 1.75), padding slots trailing
    with feature 0 and weight 0, as ``pad_csr`` lays them out."""
    rng = np.random.RandomState(seed)
    idx = np.zeros((FS_ROWS, P), np.int32)
    wts = np.zeros((FS_ROWS, P), np.float32)
    for r in range(FS_ROWS):
        n = 0 if r in (3, 17, 40) else rng.randint(1, P + 1)
        idx[r, :n] = rng.choice(FS_FEATS, n, replace=n > FS_FEATS)
        wts[r, :n] = 0.25 + 1.5 * rng.rand(n)
    return torch.tensor(idx), torch.tensor(wts)


def _candidate_ids(C: int, seed: int = 8) -> torch.Tensor:
    """Slot-major ids ``[C, FS_B]``, unsorted, with repeats, the all-padding
    rows among them."""
    ids = np.random.RandomState(seed).randint(0, FS_ROWS, (C, FS_B)).astype(np.int32)
    ids[0, :4] = [17, 5, 17, 3]
    ids[-1, -3:] = [40, 40, 5]
    return torch.tensor(ids)


def _old_composition(table, idx, wts, ids, scale, users):
    """The padded read and the scoring as the generic step composed them
    before ``feature_sums``: ``batch_representation``'s padded branch
    (gather, scale, ``_weighted_sum``) and ``losses._score_candidates``."""
    rows = ids.reshape(-1).long()
    w = wts[rows]
    if scale is not None:
        w = w * scale
    reps = rep.f32_dot(w[..., None, :], table[idx[rows].long()])[..., 0, :]
    if users is None:
        return reps, None
    C, (B, W) = ids.shape[0], users.shape
    u1 = torch.cat([users[:, :-1], torch.ones_like(users[:, -1:])], dim=-1)
    return reps, (reps.view(C, B, W) * u1[None, :, :]).sum(-1) + users[None, :, -1]


@pytest.mark.parametrize("width", [32, 72])
@pytest.mark.parametrize("P", [1, 8, 40])
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("C", [1, 11])
def test_feature_sums_plain_is_the_old_composition_bitwise(width, P, scaled, C):
    rng = np.random.RandomState(P + width)
    table = torch.tensor(rng.randn(FS_FEATS, width).astype(np.float32))
    users = torch.tensor(rng.randn(FS_B, width).astype(np.float32))
    idx, wts = _padded_rows(P)
    ids = _candidate_ids(C)
    scale = torch.tensor(np.float32(0.8125)) if scaled else None
    fs.reset_launches()
    reps, scores = fs.feature_sums(table, idx, wts, ids.reshape(-1), scale, users)
    want_reps, want_scores = _old_composition(table, idx, wts, ids, scale, users)
    assert reps.shape == (C * FS_B, width) and scores.shape == (C, FS_B)
    assert torch.equal(reps, want_reps) and torch.equal(scores, want_scores)
    # Rows of padding alone sum to zero.
    assert not reps[(ids.reshape(-1) == 3) | (ids.reshape(-1) == 40)].any()
    # Without users: the same rows, and no scores.
    alone, none = fs.feature_sums(table, idx, wts, ids.reshape(-1), scale)
    assert none is None and torch.equal(alone, want_reps)
    # The padded read of a whole table goes through the same function.
    feats = sparse.PaddedRows(idx, wts, FS_FEATS)
    assert torch.equal(rep.batch_representation(table, feats, ids, scale),
                       want_reps.view(C, FS_B, width))
    got = rep.candidate_scores(table, feats, ids, users, scale)
    assert torch.equal(got[0], want_reps) and torch.equal(got[1], want_scores)
    assert fs.launches["feature_sums"] == 0


def test_feature_sums_takes_a_python_number_as_scale():
    idx, wts = _padded_rows(8)
    table = torch.tensor(np.random.RandomState(2).randn(FS_FEATS, 16).astype(np.float32))
    ids = _candidate_ids(3).reshape(-1)
    got, _ = fs.feature_sums(table, idx, wts, ids, 0.8125)
    want, _ = fs.feature_sums(table, idx, wts, ids, torch.tensor(np.float32(0.8125)))
    assert torch.equal(got, want)
    assert torch.equal(fs.feature_sums(table, idx, wts, ids, 1.0)[0],
                       fs.feature_sums(table, idx, wts, ids)[0])


def _fs_args():
    rng = np.random.RandomState(3)
    idx, wts = _padded_rows(8)
    return dict(table=torch.tensor(rng.randn(FS_FEATS, 16).astype(np.float32)), idx=idx,
                wts=wts, ids=_candidate_ids(2).reshape(-1),
                scale=torch.tensor(np.float32(0.5)),
                users=torch.tensor(rng.randn(FS_B, 16).astype(np.float32)))


def _noncontiguous(x):
    return x.t().contiguous().t() if x.dim() == 2 else torch.stack([x, x], 1)[:, 0]


BAD_ARGS = {
    "table f64": ("table", lambda a: a.double(), TypeError),
    "idx int64": ("idx", lambda a: a.long(), TypeError),
    "wts f64": ("wts", lambda a: a.double(), TypeError),
    "ids int64": ("ids", lambda a: a.long(), TypeError),
    "users f64": ("users", lambda a: a.double(), TypeError),
    "scale f64": ("scale", lambda a: a.double(), TypeError),
    "scale a list": ("scale", lambda a: [0.5], TypeError),
    "table not a tensor": ("table", lambda a: a.numpy(), TypeError),
    "ids on meta": ("ids", lambda a: a.to("meta"), ValueError),
    "users on meta": ("users", lambda a: a.to("meta"), ValueError),
    "scale on meta": ("scale", lambda a: a.to("meta"), ValueError),
    "ids 2-D": ("ids", lambda a: a.view(2, -1), ValueError),
    "table 1-D": ("table", lambda a: a.reshape(-1), ValueError),
    "scale 1-D": ("scale", lambda a: a.reshape(1), ValueError),
    "wts narrower than idx": ("wts", lambda a: a[:, :4].contiguous(), ValueError),
    "users narrower than table": ("users", lambda a: a[:, :8].contiguous(), ValueError),
    "ids not whole rows of users": ("ids", lambda a: a[:-1].contiguous(), ValueError),
    "table not contiguous": ("table", _noncontiguous, ValueError),
    "idx not contiguous": ("idx", _noncontiguous, ValueError),
    "wts not contiguous": ("wts", _noncontiguous, ValueError),
    "ids not contiguous": ("ids", _noncontiguous, ValueError),
    "users not contiguous": ("users", _noncontiguous, ValueError),
}


@pytest.mark.parametrize("case", list(BAD_ARGS))
def test_feature_sums_refuses_what_it_does_not_take(case):
    name, bad, error = BAD_ARGS[case]
    args = _fs_args()
    fs.feature_sums(**args)  # the unaltered arguments are taken
    args[name] = bad(args[name])
    with pytest.raises(error):
        fs.feature_sums(**args)


def test_feature_sums_counts_no_launch_and_no_rows_on_the_cpu():
    fs.reset_launches()
    with observability.recording() as rec:
        fs.feature_sums(**_fs_args())
    assert fs.launches == {"feature_sums": 0}
    assert [s.name for s in rec.spans] == ["kernel.feature_sums"]
    assert "feature_sum_rows" not in rec.counters


# ---------------------------------------------------------------------------
# The generic steps' scoring through candidate_scores, against the old one
# ---------------------------------------------------------------------------

ST_USERS, ST_ITEMS, ST_TAGS, ST_B, ST_D = 90, 120, 30, 64, 6


def _step_inputs(loss: str, alpha: float):
    """A generic step's inputs on the CPU: interactions, items as 1 to 5
    tags (``PaddedRows`` of width 8), identity users, a random state and
    the loss's draws."""
    rng = np.random.RandomState(11)
    rows = np.repeat(np.arange(ST_USERS), 8)
    cols = rng.randint(0, ST_ITEMS, rows.size)
    coo = sp.coo_matrix((np.ones(rows.size, np.float32), (rows, cols)),
                        shape=(ST_USERS, ST_ITEMS))
    n_tags = rng.randint(1, 6, ST_ITEMS)
    tag_rows = np.repeat(np.arange(ST_ITEMS), n_tags)
    tags = sp.coo_matrix((0.5 + rng.rand(tag_rows.size).astype(np.float32),
                          (tag_rows, rng.randint(0, ST_TAGS, tag_rows.size))),
                         shape=(ST_ITEMS, ST_TAGS)).tocsr()
    item_feats = sparse.pad_csr(tags, device="cpu", pad_multiple=8)
    assert isinstance(item_feats, sparse.PaddedRows)
    user_feats = sparse.identity_rows(ST_USERS)
    hp = config.Hyperparams(loss=loss, no_components=ST_D, item_alpha=alpha, user_alpha=alpha,
                            learning_rate=0.1, max_sampled=10, n=6, k=3, bpr_tries=8)
    data = train.build_train_data(coo, np.ones_like(coo.data), user_feats, item_feats, hp,
                                  ST_B, "cpu")
    W = table_width(ST_D)
    arrays = {}
    for side, n in (("item", ST_TAGS), ("user", ST_USERS)):
        arrays[f"{side}_table"] = (0.3 * rng.randn(n, W)).astype(np.float32)
        arrays[f"{side}_acc"] = (1 + rng.rand(n, W)).astype(np.float32)
        arrays[f"{side}_mom"] = np.zeros((n, W), np.float32)
    arrays["item_log_scale"] = np.float32(0.3 if alpha else 0.0)
    arrays["user_log_scale"] = np.float32(0.2 if alpha else 0.0)
    batch = _unpack_batch5(data.packed[:, :ST_B])
    if loss == "warp":
        draws = torch.tensor(rng.randint(0, ST_ITEMS, (hp.max_sampled, ST_B)), dtype=torch.int32)
    elif loss == "bpr":
        draws = torch.tensor(rng.randint(0, coo.nnz, (ST_B, hp.bpr_tries)), dtype=torch.int32)
    else:
        lens = data.positives.lengths[batch.user_ids.long()]
        slots = losses.kos_slots(torch.tensor(rng.rand(hp.n, ST_B), dtype=torch.float32), lens)
        draws = (slots, torch.tensor(rng.randint(0, ST_ITEMS, (hp.max_sampled, ST_B)),
                                     dtype=torch.int32))
    return arrays, batch, user_feats, item_feats, data, hp, draws


@pytest.mark.parametrize("loss, fused_calls", [("warp", 1), ("bpr", 1), ("warp-kos", 2)])
@pytest.mark.parametrize("alpha", [0.0, 1e-3])
def test_generic_steps_score_as_before(loss, fused_calls, alpha, monkeypatch):
    """The WARP, BPR and k-OS steps over padded item features score every
    candidate in one ``feature_sums`` call (k-OS: its positives and its
    negatives) and leave the state bitwise as the old composition does."""
    arrays, batch, uf, itf, data, hp, draws = _step_inputs(loss, alpha)
    step = losses.LOSS_STEPS[loss]

    def run():
        return step(interop.state_from_numpy(arrays, "cpu"), batch, uf, itf, data.positives,
                    data.train_items, hp, draws)

    calls = []
    fused = rep.feature_sums
    monkeypatch.setattr(rep, "feature_sums",
                        lambda *a, **k: calls.append(k.get("users", a[5] if len(a) > 5
                                                           else None)) or fused(*a, **k))
    got = run()
    assert len(calls) == fused_calls and all(u is not None for u in calls)

    def old(table, features, ids, user_rep, scale=None, placement=None):
        assert placement is None
        return _old_composition(table, features.idx, features.wts, ids, scale, user_rep)

    monkeypatch.setattr(losses, "candidate_scores", old)
    want = run()
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert not torch.equal(got.item_table, torch.tensor(arrays["item_table"]))
