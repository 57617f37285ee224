"""The hybrid (feature-matrix) fast path of lightfm_tpu_torch vs the JAX package, on the CPU.

Same inputs through both packages: the transposed feature walk in its three
tiers, the transposed-structure build, the aggregated and expanded-touch
feature updates, hybrid WARP and BPR steps and epochs given the same random
draws (derived from a JAX key as ``tests/test_torch_fast_warp.py`` derives
them), and whole hybrid fits compared statistically.

Tolerances: walks, updates, steps and epochs run at
``fast_precision="highest"`` (the JAX package ignores DEFAULT on the CPU)
and agree to f32 summation order, ``|got - want| <= 1e-5 + 1e-5 * |want|``
per element (both packages sum the same terms in other orders).  The
``"default"`` walk is held against a numpy float64 model of the bf16
operand rounding, to ``2^-22 * sum|terms|``.  Whole fits draw different
random numbers in the two packages and are compared by AUC (within 0.02,
the bar of ``tests/test_fast_warp.py:431``).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import lightfm_tpu
from lightfm_tpu import config as jax_config
from lightfm_tpu import fast_warp as jax_fw
from lightfm_tpu import train as jax_train
from lightfm_tpu.evaluation import auc_score as jax_auc

import lightfm_tpu_torch
from lightfm_tpu_torch import config, fast_warp as fw, interop, train
from lightfm_tpu_torch.evaluation import auc_score
from lightfm_tpu_torch.sparse import ChunkedRows, PaddedRows, identity_rows

from test_fast_warp import _planted, _tag_feats
from test_torch_fast_warp import (
    _assert_generic_like_jax,
    _assert_states_close,
    _bf16_np,
    _interactions,
    _jax_draws,
    _jax_state,
    _random_state,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    worker processes side by side, and each one's OpenMP pool spinning on
    every core slows all of them by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tm(**kw):
    return lightfm_tpu_torch.LightFM(device="cpu", **kw)


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want) - 1e-5 * np.abs(want)
    assert (err <= 1e-5).all(), float(err.max())


# ---------------------------------------------------------------------------
# The transposed walk and its build
# ---------------------------------------------------------------------------


def _chunked_transpose(rng, n_items=300, n_feats=400):
    """A transposed matrix whose one very wide row spills into ChunkedRows
    overflow chunks under ``_pad_features``' width cap."""
    dense = (rng.rand(n_feats, n_items) < 0.01).astype(np.float32) * (rng.rand(n_feats, n_items) + 0.5)
    dense[7, :] = rng.rand(n_items) + 0.5  # one feature carried by every entity
    return sp.csr_matrix(dense.astype(np.float32))


def _tiered(rng, n_items=60, n_feats=30):
    """``tests/test_fast_warp.py:547``'s matrix: thin columns plus two fat ones."""
    dense_f = np.zeros((n_items, n_feats), np.float32)
    for f in range(n_feats - 2):
        dense_f[rng.randint(0, n_items, 2), f] = 1.0
    dense_f[: n_items - 5, n_feats - 2] = 1.0
    dense_f[5:, n_feats - 1] = 1.0
    return sp.csr_matrix(dense_f)


@pytest.mark.parametrize("tier", ["padded", "chunked", "thin-fat"])
def test_transposed_feature_sums_match_jax(tier):
    rng = np.random.RandomState(0)
    W = 8
    if tier == "padded":
        feats = sp.random(50, 37, density=0.15, random_state=1, format="csr", dtype=np.float32)
        feats.data = rng.rand(feats.nnz).astype(np.float32) + 0.5
        jT = lightfm_tpu.LightFM._pad_features(feats.T.tocsr())
        tT = _tm()._pad_features(feats.T.tocsr())
        assert isinstance(tT, PaddedRows)
    elif tier == "chunked":
        csr_t = _chunked_transpose(rng)
        feats = csr_t.T.tocsr()
        jT = lightfm_tpu.LightFM._pad_features(csr_t)
        tT = _tm()._pad_features(csr_t)
        assert isinstance(tT, ChunkedRows) and isinstance(jT, lightfm_tpu.sparse.ChunkedRows)
    else:
        feats = _tiered(rng)
        jT = lightfm_tpu.LightFM(loss="warp")._build_transposed(feats, "highest")
        tT = _tm(loss="warp")._build_transposed(feats, "highest")
        assert tT.fat_rows is not None and tT.fat_w.dtype == torch.float32
    n_items = feats.shape[0]
    G = rng.randn(n_items, 2 * W).astype(np.float32)
    want = np.asarray(jax_fw._transposed_feature_sums(jT, jnp.asarray(G), block=16))
    got = fw._transposed_feature_sums(tT, torch.tensor(G), block=16).numpy()
    assert got.shape == want.shape == (feats.shape[1], 2 * W)
    _close(got, want)
    dense = feats.toarray().astype(np.float64)
    _close(got, np.concatenate([dense.T @ G[:, :W], (dense * dense).T @ G[:, W:]], axis=1))


def test_transposed_feature_sums_default_rounds_operands_to_bf16():
    rng = np.random.RandomState(2)
    feats = _tiered(rng)
    feats.data = (rng.rand(feats.nnz) + 0.5).astype(np.float32)  # not bf16-exact: f32 storage
    tT = _tm(loss="warp")._build_transposed(feats, "default")
    assert tT.fat_w.dtype == torch.float32 and tT.fat_w2 is not tT.fat_w
    W = 8
    G = rng.randn(feats.shape[0], 2 * W).astype(np.float32)
    got = fw._transposed_feature_sums(tT, torch.tensor(G), precision="default").numpy()
    dense = feats.toarray()
    w, w2 = _bf16_np(dense).astype(np.float64), _bf16_np(dense * dense).astype(np.float64)
    g = _bf16_np(G).astype(np.float64)
    want = np.concatenate([w.T @ g[:, :W], w2.T @ g[:, W:]], axis=1)
    bound = np.concatenate([np.abs(w).T @ np.abs(g[:, :W]), np.abs(w2).T @ np.abs(g[:, W:])], 1)
    assert (np.abs(got - want) <= bound * 2.0 ** -22 * feats.shape[0]).all()
    highest = fw._transposed_feature_sums(tT, torch.tensor(G), precision="highest").numpy()
    assert np.abs(got - highest).max() > 1e-4  # the rounding is really applied


def test_build_transposed_matches_jax(monkeypatch):
    rng = np.random.RandomState(1)
    csr = _tiered(rng)
    for prec, dtype in (("highest", torch.float32), ("default", torch.bfloat16)):
        j = lightfm_tpu.LightFM(loss="warp")._build_transposed(csr, prec)
        t = _tm(loss="warp")._build_transposed(csr, prec)
        assert np.array_equal(t.fat_rows.numpy(), np.asarray(j.fat_rows))
        assert np.array_equal(t.thin.idx.numpy(), np.asarray(j.thin.idx))
        assert np.array_equal(t.thin.wts.numpy(), np.asarray(j.thin.wts))
        assert t.fat_w.dtype == dtype
        assert np.array_equal(t.fat_w.float().numpy(), np.asarray(j.fat_w, np.float32))
        assert t.fat_w2 is t.fat_w  # binary weights share one matrix

    # Weights of 2.0 (duplicate tag entries) need a separate squared matrix,
    # still bf16-exact (``tests/test_fast_warp.py:584``).
    rows = np.repeat(np.arange(400), 3)
    tags = sp.coo_matrix((np.ones(rows.size, np.float32), (rows, rng.randint(0, 16, rows.size))),
                         shape=(400, 16)).tocsr()
    feats = sp.hstack([sp.identity(400, dtype=np.float32, format="csr"), tags], format="csr")
    t = _tm(loss="warp")._build_transposed(feats, "default")
    assert t.fat_w2 is not t.fat_w and t.fat_w.dtype == torch.bfloat16
    j = lightfm_tpu.LightFM(loss="warp")._build_transposed(feats, "default")
    assert np.array_equal(t.fat_w2.float().numpy(), np.asarray(j.fat_w2, np.float32))
    # No fat row: thin tier only.
    ident = sp.identity(50, dtype=np.float32, format="csr")
    t0 = _tm(loss="warp")._build_transposed(ident, "default")
    assert t0.fat_rows is None and t0.thin.max_nnz == 1
    # Over the budget: None (the expanded-touch scatter path), in both.
    monkeypatch.setenv("LIGHTFM_TPU_FAT_TIER_BYTES", "64")
    assert _tm(loss="warp")._build_transposed(feats, "default") is None
    assert lightfm_tpu.LightFM(loss="warp")._build_transposed(feats, "default") is None


def test_transposed_features_gate_and_memo():
    from lightfm_tpu_torch import model as tmodel

    feats = _tag_feats(500, n_tags=40)
    m = _tm(loss="warp")
    padded = m._pad_features(feats)
    assert m._transposed_features(feats, identity_rows(500), 1024, "default") is None
    # entities + features beyond 32 batches: None
    assert m._transposed_features(feats, padded, (500 + 540) // 32 - 1, "default") is None
    first = m._transposed_features(feats, padded, 1024, "default")
    assert isinstance(first, fw.TransposedFeats) and first.fat_rows is not None
    # A fresh model on the same matrix reuses the memoized structure.
    assert _tm(loss="warp")._transposed_features(feats, padded, 1024, "default") is first
    assert m._transposed_features(feats, padded, 1024, "highest") is not first
    assert any(k[2] == id(feats) for k in tmodel._TRANSPOSE_MEMO)


@pytest.mark.parametrize("variant", ["aggregated", "scatter"])
def test_feature_updates_match_jax(variant):
    rng = np.random.RandomState(3)
    n_items, W, B = 300, 16, 200
    feats = _tag_feats(n_items, n_tags=30)
    n_feats = feats.shape[1]
    table = rng.randn(n_feats, W).astype(np.float32)
    acc = (1 + rng.rand(n_feats, W)).astype(np.float32)
    jt, ja = jnp.asarray(table), jnp.asarray(acc)
    tt, ta = torch.tensor(table), torch.tensor(acc)
    if variant == "aggregated":
        G = np.concatenate([rng.randn(n_items, W), rng.rand(n_items, W)], 1).astype(np.float32)
        G[::3] = 0.0  # untouched entities
        jT = lightfm_tpu.LightFM(loss="warp")._build_transposed(feats, "highest")
        want = jax_fw._aggregated_feature_update(jt, ja, jT, jnp.asarray(G), 0.05)
        fw._aggregated_feature_update(tt, ta, _tm(loss="warp")._build_transposed(feats, "highest"),
                                      torch.tensor(G), 0.05)
    else:
        rows = rng.randint(0, n_items, B).astype(np.int32)
        g = rng.randn(B, W).astype(np.float32)
        g2 = rng.rand(B, W).astype(np.float32)
        jf = lightfm_tpu.LightFM._pad_features(feats)
        want = jax_fw._feature_update(jt, ja, jf, jnp.asarray(rows), jnp.asarray(g), 0.05)
        want = jax_fw._feature_update(*want, jf, jnp.asarray(rows), jnp.asarray(g), 0.05,
                                      g2=jnp.asarray(g2))
        tf = _tm()._pad_features(feats)
        fw._feature_update(tt, ta, tf, torch.tensor(rows), torch.tensor(g), 0.05)
        fw._feature_update(tt, ta, tf, torch.tensor(rows), torch.tensor(g), 0.05,
                           g2=torch.tensor(g2))
    _close(tt.numpy(), want[0])
    _close(ta.numpy(), want[1])
    assert not np.array_equal(tt.numpy(), table)


# ---------------------------------------------------------------------------
# Steps and epochs against JAX, same draws
# ---------------------------------------------------------------------------


def _both_hybrid(coo, loss, B, item_csr, user_csr, transposed):
    kw = dict(loss=loss, no_components=8, fast_precision="highest")
    jm, tm = lightfm_tpu.LightFM(**kw), _tm(**kw)
    nu, ni = coo.shape
    w = np.ones_like(coo.data)

    def side(csr, n, model, ident):
        return ident(n) if csr is None else model._pad_features(csr)

    jd = jax_train.build_train_data(
        coo, w, side(user_csr, nu, jm, lightfm_tpu.sparse.identity_rows),
        side(item_csr, ni, jm, lightfm_tpu.sparse.identity_rows),
        jax_config.Hyperparams(**kw), B,
    )
    td = train.build_train_data(
        coo, w, side(user_csr, nu, tm, identity_rows), side(item_csr, ni, tm, identity_rows),
        config.Hyperparams(**kw), B, "cpu",
    )
    if transposed:
        def tr(model, csr):
            return None if csr is None else model._build_transposed(csr, "highest")

        jd = jd._replace(user_feats_T=tr(jm, user_csr), item_feats_T=tr(jm, item_csr))
        td = td._replace(user_feats_T=tr(tm, user_csr), item_feats_T=tr(tm, item_csr))
        for csr, T in ((user_csr, td.user_feats_T), (item_csr, td.item_feats_T)):
            assert (csr is None) == (T is None) and (T is None or T.fat_rows is not None)
    n_u = nu if user_csr is None else user_csr.shape[1]
    n_i = ni if item_csr is None else item_csr.shape[1]
    return jd, td, n_u, n_i


def _feat_kw(d):
    return dict(user_feats=d.user_feats, item_feats=d.item_feats,
                user_feats_T=d.user_feats_T, item_feats_T=d.item_feats_T)


@pytest.mark.parametrize(
    "loss, sides, transposed",
    [
        ("warp", "item", True),
        ("warp", "item", False),
        ("warp", "user", True),
        ("warp", "user", False),
        ("warp", "both", True),
        ("bpr", "item", True),
        ("bpr", "user", False),
    ],
)
def test_hybrid_step_matches_jax(loss, sides, transposed):
    nu, ni, B, D = 900, 3000, 1024, 8
    coo = _interactions(nu, ni, 4, seed=1)
    item_csr = _tag_feats(ni, n_tags=300) if sides in ("item", "both") else None
    user_csr = _tag_feats(nu, n_tags=60) if sides in ("user", "both") else None
    jd, td, n_u, n_i = _both_hybrid(coo, loss, B, item_csr, user_csr, transposed)
    n_pad = td.packed.shape[1]
    kw = dict(loss=loss, no_components=D, fast_precision="highest", max_sampled=10,
              bpr_tries=8, learning_rate=0.07)
    jhp, thp = jax_config.Hyperparams(**kw), config.Hyperparams(**kw)
    draws, keys = _jax_draws(jax.random.key(11), n_pad, B, loss, "feistel", n_items=ni,
                             n_examples=coo.nnz, K=10 if loss == "warp" else 8)
    shuffled, suid, sigma = fw.shuffle_item_sorted(td.packed, draws.perm, n_pad // B, B)
    arrays = _random_state(n_i, n_u, D, seed=2)
    tstate = interop.state_from_numpy(arrays, "cpu")
    tb = fw._unpack_batch5(shuffled[0])
    jb = jax_fw._unpack_batch5(jnp.asarray(shuffled[0].numpy()))
    js, jg = jnp.asarray(suid[0].numpy()), jnp.asarray(sigma[0].numpy())
    if loss == "warp":
        want = jax_fw.warp_pool_step(_jax_state(arrays), jb, jd.positives, js, jg, jhp, keys[0],
                                     n_items=ni, use_pallas=False, user_pallas=True,
                                     **_feat_kw(jd))
        got = fw.warp_pool_step(tstate, tb, td.positives, suid[0], sigma[0], thp,
                                draws.pool[0], draws.shifts[0], n_items=ni, user_pallas=True,
                                **_feat_kw(td))
    else:
        want = jax_fw.bpr_pool_step(_jax_state(arrays), jb, jd.positives, jd.train_items, js, jg,
                                    jhp, keys[0], n_items=ni, use_pallas=False,
                                    user_pallas=True, **_feat_kw(jd))
        got = fw.bpr_pool_step(tstate, tb, td.positives, td.train_items, suid[0], sigma[0], thp,
                               draws.pool[0], draws.shifts[0], user_pallas=True, **_feat_kw(td))
    assert got is tstate  # in place
    _assert_states_close(got, want)
    assert not np.array_equal(got.item_table.numpy(), arrays["item_table"])
    assert not np.array_equal(got.user_table.numpy(), arrays["user_table"])


@pytest.mark.parametrize("loss, sides", [("warp", "both"), ("bpr", "item")])
def test_hybrid_epoch_matches_jax(loss, sides):
    nu, ni, B, D = 400, 2500, 1024, 8
    coo = _interactions(nu, ni, 8, seed=4)
    item_csr = _tag_feats(ni, n_tags=250)
    user_csr = _tag_feats(nu, n_tags=40) if sides == "both" else None
    jd, td, n_u, n_i = _both_hybrid(coo, loss, B, item_csr, user_csr, True)
    kw = dict(loss=loss, no_components=D, fast_precision="highest", max_sampled=10, bpr_tries=8)
    jhp, thp = jax_config.Hyperparams(**kw), config.Hyperparams(**kw)
    key = jax.random.key(5)
    draws, _ = _jax_draws(key, td.packed.shape[1], B, loss, "feistel", n_items=ni,
                          n_examples=coo.nnz, K=10 if loss == "warp" else 8)
    arrays = _random_state(n_i, n_u, D, seed=6)
    want = jax_fw.fast_epoch(_jax_state(arrays), jd, key, jhp, B)
    got = fw.fast_epoch(interop.state_from_numpy(arrays, "cpu"), td, draws, thp, B)
    _assert_states_close(got, want)


# ---------------------------------------------------------------------------
# Whole fits, no-ops, eligibility
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def planted():
    return _planted()


def test_hybrid_fit_matches_jax_statistically(planted):
    """5 hybrid WARP epochs at D=64 on ``tests/test_fast_warp.py:431``'s
    setup: AUC > 0.9 and within 0.02 of the JAX fast path's."""
    feats = _tag_feats(8000)
    csr = planted.tocsr()
    tm = _tm(loss="warp", no_components=64, random_state=10, fast_path="on")
    tm.fit(planted, epochs=5, item_features=feats)
    data = tm._staged_train_data
    assert tm._staged_fast == "einsum"
    assert data.item_feats_T is not None and data.item_feats_T.fat_rows is not None
    assert data.user_feats_T is None  # identity users
    port = float(auc_score(tm, csr, item_features=feats).mean())
    jm = lightfm_tpu.LightFM(loss="warp", no_components=64, random_state=10, fast_path="on")
    jm.fit(planted, epochs=5, item_features=feats)
    assert jm._staged_fast
    want = float(jax_auc(jm, csr, item_features=feats).mean())
    assert port > 0.9, (port, want)
    assert abs(port - want) < 0.02, (port, want)
    with pytest.raises(ValueError, match="item_features"):
        tm.recommend([0, 1], k=5)  # a hybrid model needs its features to serve


def test_hybrid_user_features_fit_and_determinism(planted):
    feats = _tag_feats(1500)
    runs = []
    for _ in range(2):
        m = _tm(loss="warp", no_components=64, random_state=10, fast_path="on")
        m.fit(planted, epochs=2, user_features=feats)
        assert m._staged_train_data.user_feats_T is not None
        runs.append(m._state)
    for a, b in zip(*runs):
        assert torch.equal(a, b)  # seeded: bitwise equal
    m.fit_partial(planted, epochs=3, user_features=feats)
    assert float(auc_score(m, planted.tocsr(), user_features=feats).mean()) > 0.9


@pytest.mark.parametrize("transposed", [True, False])
def test_hybrid_all_masked_epoch_is_a_noop(planted, transposed):
    """``tests/test_fast_warp.py:471``: y <= 0 everywhere, so every update
    through the dense aggregated (or the scatter) update is an exact no-op."""
    feats = _tag_feats(8000)
    coo = planted.copy()
    coo.data = -np.ones_like(coo.data)
    m = _tm(loss="warp", no_components=64, random_state=10, fast_path="on")
    m.fit(coo, epochs=0, item_features=feats, user_features=_tag_feats(1500))
    data = m._staged_train_data
    assert data.item_feats_T is not None and data.user_feats_T is not None
    if not transposed:
        data = data._replace(item_feats_T=None, user_feats_T=None)
    before = m._state
    after = train.run_epochs(before, data, [1], m._staged_hp, m._staged_batch_size,
                             fast=m._staged_fast)
    for name in ("item_table", "user_table", "item_acc", "user_acc"):
        assert torch.equal(getattr(after, name), getattr(before, name)), name


def test_hybrid_eligibility_gate(planted):
    feats = _tag_feats(8000)
    for loss in ("warp", "bpr"):
        m = _tm(loss=loss, no_components=64, random_state=10, fast_path="on")
        m.fit(planted, epochs=0, item_features=feats)
        assert m._staged_fast == "einsum" and m._item_features_used and not m._user_features_used
    # Logistic's fast path is identity-only, and rows wider than
    # MAX_FAST_FEAT_NNZ belong on the generic path: both train there.
    _assert_generic_like_jax(planted, item_features=feats, loss="logistic", fast_path="on")
    wide = _tag_feats(8000, per_item=fw.MAX_FAST_FEAT_NNZ + 1)
    _assert_generic_like_jax(planted, item_features=wide, loss="warp", fast_path="on")
    assert fw._feats_eligible(identity_rows(5))
    padded = _tm()._pad_features(wide)
    assert padded.max_nnz > fw.MAX_FAST_FEAT_NNZ and not fw._feats_eligible(padded)
    assert not fw._feats_eligible(_tm()._pad_features(_chunked_transpose(np.random.RandomState(0))))
