"""lightfm_tpu_torch.train and LightFM.fit vs the JAX package, on the CPU.

The staged training set (packed block, positives, BPR's item column) must
be bitwise equal to the JAX package's, ``choose_batch_size`` equal over a
sweep, and a whole fast-path WARP fit must land within 0.02 AUC of the JAX
package's fast and generic fits on the same data (the statistical bar of
``tests/test_fast_warp.py:170``; the two packages draw different random
numbers, so whole fits are compared by quality, not element-wise).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightfm_tpu
from lightfm_tpu import config as jax_config
from lightfm_tpu import train as jax_train
from lightfm_tpu.evaluation import auc_score as jax_auc

import lightfm_tpu_torch
from lightfm_tpu_torch import config, train
from lightfm_tpu_torch.evaluation import auc_score
from lightfm_tpu_torch.sparse import identity_rows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    worker processes side by side, and each one's OpenMP pool spinning on
    every core slows all of them by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _coo(seed=0, nu=300, ni=500, nnz=4000, heavy=None, signed=False):
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, nu, nnz)
    cols = rng.randint(0, ni, nnz)
    if heavy is not None:  # one user with more than the 512-wide cap
        rows = np.concatenate([rows, np.full(heavy, 7)])
        cols = np.concatenate([cols, rng.randint(0, ni, heavy)])
    vals = rng.choice([-1.0, 1.0, 2.5], rows.size) if signed else np.ones(rows.size)
    # Duplicates are kept: the packed block carries them as they are.
    return sp.coo_matrix((vals.astype(np.float32), (rows, cols)), shape=(nu, ni))


@pytest.mark.parametrize(
    "loss, kw",
    [
        ("warp", {}),
        ("warp", dict(heavy=700)),  # positives width capped at 512
        ("bpr", {}),
        ("logistic", dict(signed=True)),
        ("warp-kos", dict(heavy=700)),  # k-OS keeps full rows
    ],
)
@pytest.mark.parametrize("batch_size", [1024, 3000])
def test_build_train_data_matches_jax_bitwise(loss, kw, batch_size):
    coo = _coo(**kw)
    rng = np.random.RandomState(1)
    weights = (rng.rand(coo.nnz) + 0.5).astype(np.float32) if kw.get("signed") else np.ones(
        coo.nnz, np.float32
    )
    nu, ni = coo.shape
    jd = jax_train.build_train_data(
        coo, weights, lightfm_tpu.sparse.identity_rows(nu),
        lightfm_tpu.sparse.identity_rows(ni), jax_config.Hyperparams(loss=loss), batch_size,
    )
    td = train.build_train_data(
        coo, weights, identity_rows(nu), identity_rows(ni), config.Hyperparams(loss=loss),
        batch_size, "cpu",
    )
    assert td.packed.dtype == torch.int32
    assert np.array_equal(td.packed.numpy(), np.asarray(jd.packed))
    if jd.positives is None:
        assert td.positives is None
    else:
        assert np.array_equal(td.positives.idx.numpy(), np.asarray(jd.positives.idx))
        assert np.array_equal(td.positives.lengths.numpy(), np.asarray(jd.positives.lengths))
        assert td.positives.n_cols == jd.positives.n_cols
    if jd.train_items is None:
        assert td.train_items is None
    else:
        assert np.array_equal(td.train_items.numpy(), np.asarray(jd.train_items))


def test_choose_batch_size_matches_jax():
    sizes = [0, 1, 500, 1023, 65_536, 70_000, (1 << 19), (1 << 19) + 1, 1_000_000,
             2_621_440, 5_000_000, 25_000_000, 100_000_000]
    for n in sizes:
        for req in (None, 4096):
            assert train.choose_batch_size(n, req) == jax_train.choose_batch_size(n, req), (n, req)


def _planted(nu=1500, ni=8000, per_user=30, d=16, seed=7):
    rng = np.random.RandomState(seed)
    top = np.argsort(-(rng.randn(nu, d) @ rng.randn(ni, d).T), axis=1)[:, :per_user]
    rows = np.repeat(np.arange(nu), per_user)
    return sp.coo_matrix(
        (np.ones(len(rows), np.float32), (rows, top.ravel())), shape=(nu, ni)
    )


def test_whole_warp_fit_matches_jax_statistically():
    """5 epochs of WARP at D=64 on the planted fixture of
    ``tests/test_fast_warp.py:24``: AUC > 0.95, and within 0.02 of the JAX
    package's fast and generic fits."""
    data = _planted()
    csr = data.tocsr()
    tm = lightfm_tpu_torch.LightFM(loss="warp", no_components=64, random_state=10,
                                   fast_path="on", device="cpu")
    tm.fit(data, epochs=5)
    assert tm._staged_fast == "einsum"
    port = float(auc_score(tm, csr).mean())
    aucs = {}
    for fast_path in ("on", "off"):
        jm = lightfm_tpu.LightFM(loss="warp", no_components=64, random_state=10,
                                 fast_path=fast_path)
        jm.fit(data, epochs=5)
        assert bool(jm._staged_fast) == (fast_path == "on")
        aucs[fast_path] = float(jax_auc(jm, csr).mean())
    assert port > 0.95, (port, aucs)
    assert abs(port - aucs["on"]) < 0.02 and abs(port - aucs["off"]) < 0.02, (port, aucs)
    # Seeded: the same random_state gives the same model, bitwise.
    again = lightfm_tpu_torch.LightFM(loss="warp", no_components=64, random_state=10,
                                      fast_path="on", device="cpu").fit(data, epochs=5)
    assert torch.equal(again._state.item_table, tm._state.item_table)


def test_fit_partial_resumes_and_default_precision_trains():
    data = _planted(nu=600, ni=8000, per_user=20)
    m = lightfm_tpu_torch.LightFM(loss="warp", no_components=64, random_state=3,
                                  fast_path="on", device="cpu")
    assert m.fast_precision == "default"
    m.fit(data, epochs=2)
    first = m._state.item_table.clone()
    m.fit_partial(data, epochs=2)
    assert not torch.equal(m._state.item_table, first)
    assert float(auc_score(m, data.tocsr()).mean()) > 0.9
    assert m.n_users_ == 600 and m.n_items_ == 8000
