"""The port's data-parallel fast path on two gloo ranks, on the CPU.

- One fast epoch per loss (WARP, BPR, logistic) on a 2-rank mesh against
  the JAX package's ``mesh=`` fast epoch on 2 of the 8 virtual CPU devices
  (``tests/conftest.py``), the port fed the draws derived from the same
  key (``tests/test_torch_fast_warp.py``'s ``_jax_draws``), and against
  the port's one-device epoch with the same draws.
- ``tests/test_fast_warp_mesh.py``'s four tests through ``LightFM``.

Small batches need the pool shrunk, as ``tests/test_fast_warp_mesh.py:45-51``
does (``POOL_SIZE = 512``); the ranks set the port's ``POOL_SIZE``
themselves, since a ``monkeypatch`` does not reach them.  Tolerance:
``rtol=2e-5, atol=2e-6`` (``tests/test_fast_warp_mesh.py:81``), at
``fast_precision="highest"`` against JAX; the two ranks bitwise, always.
This file runs itself as the ranks' script (``tests/_torch_ranks.py``).
"""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_ranks import launch, worker

if __name__ != "__main__":  # the test process; the ranks import the port alone
    import jax
    import jax.numpy as jnp

    import lightfm_tpu
    import lightfm_tpu.fast_warp as jax_fw
    import lightfm_tpu.parallel as jax_parallel
    from lightfm_tpu import config as jax_config
    from lightfm_tpu import train as jax_train
    from lightfm_tpu.state import ModelState as JaxState

import lightfm_tpu_torch
from lightfm_tpu_torch import config, fast_warp as fw, interop, train
from lightfm_tpu_torch.parallel import make_mesh
from lightfm_tpu_torch.sparse import identity_rows
from lightfm_tpu_torch.state import ModelState, table_width

SCRIPT = os.path.abspath(__file__)
N_DATA = 2
POOL = 512  # tests/test_fast_warp_mesh.py:51
LOSSES = ("warp", "bpr", "logistic")
_KW = dict(no_components=64, random_state=10, batch_size=4096)  # test_fast_warp_mesh.py:54


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _small_pool():
    """Both packages' pool shrunk so a rank's 2,048 examples are whole pools."""
    saved = fw.POOL_SIZE, jax_fw.POOL_SIZE
    fw.POOL_SIZE = jax_fw.POOL_SIZE = POOL
    yield
    fw.POOL_SIZE, jax_fw.POOL_SIZE = saved


def _planted(nu=1500, ni=8000, per_user=30, d=16, seed=7):
    """``tests/test_fast_warp_mesh.py``'s planted set."""
    rng = np.random.RandomState(seed)
    top = np.argsort(-(rng.randn(nu, d) @ rng.randn(ni, d).T), axis=1)[:, :per_user]
    rows = np.repeat(np.arange(nu), per_user)
    return sp.coo_matrix((np.ones(rows.size, np.float32), (rows, top.ravel())), shape=(nu, ni))


def _tm(**kw):
    return lightfm_tpu_torch.LightFM(**{**_KW, "device": "cpu", "fast_path": "on", **kw})


def _assert_close(got, want, what):
    err = np.abs(got - want) - 2e-5 * np.abs(want)
    assert (err <= 2e-6).all(), (what, float(err.max()))


# ---------------------------------------------------------------------------
# One epoch against the JAX package, same draws
# ---------------------------------------------------------------------------

EP_USERS, EP_ITEMS, EP_B, EP_D = 400, 2500, 2048, 16


def _epoch_coo(loss):
    rng = np.random.RandomState(4)
    rows = np.repeat(np.arange(EP_USERS), 15)
    cols = rng.randint(0, EP_ITEMS, rows.size)
    vals = np.where(rng.rand(rows.size) < 0.3, -1.0, 1.0) if loss == "logistic" else 1.0
    coo = sp.coo_matrix((np.ones(rows.size, np.float32) * vals, (rows, cols)),
                        shape=(EP_USERS, EP_ITEMS))
    coo.sum_duplicates()
    coo.data = np.sign(coo.data).astype(np.float32)
    coo.eliminate_zeros()
    return coo


def _epoch_hp(loss):
    return dict(loss=loss, no_components=EP_D, fast_precision="highest", max_sampled=10,
                bpr_tries=8)


def _random_state(seed):
    rng = np.random.RandomState(seed)
    W = table_width(EP_D)
    out = {}
    for side, n in (("item", EP_ITEMS), ("user", EP_USERS)):
        t = np.zeros((n, W), np.float32)
        t[:, :EP_D] = rng.randn(n, EP_D) / np.sqrt(EP_D)
        t[:, -1] = 0.1 * rng.randn(n)
        out[f"{side}_table"] = t
        out[f"{side}_acc"] = (1 + rng.rand(*t.shape)).astype(np.float32)
        out[f"{side}_mom"] = np.zeros_like(t)
    out["item_log_scale"] = np.float32(0)
    out["user_log_scale"] = np.float32(0)
    return out


def _jax_draws(key, n_pad, loss, n_examples):
    """The fast epoch's draws from ``key`` as the JAX package draws them
    (``fast_warp.py:1063-1064``, ``:828``, ``:837-838``, ``:939-942``); the
    mesh's pool is ``min(POOL_SIZE, B_local * n_shards)`` (``:825``)."""
    kperm, kbatch = jax.random.split(key)
    keys = jax.random.split(kbatch, n_pad // EP_B)
    out = {"perm": np.asarray(jax.random.bits(kperm, (4,), jnp.uint32)).astype(np.int64)}
    if loss == "logistic":
        return out
    P = min(POOL, EP_B)
    high, K = (n_examples, 8) if loss == "bpr" else (EP_ITEMS, 10)
    pools, shifts = [], []
    for bkey in keys:
        kp, kr = jax.random.split(bkey)
        pools.append(np.asarray(jax.random.randint(kp, (P,), 0, high, dtype=jnp.int32)))
        shifts.append(np.asarray(jax.random.randint(kr, (K,), 0, P, dtype=jnp.int32)))
    out["pool"], out["shifts"] = np.stack(pools), np.stack(shifts)
    return out


def _epoch_draws(inputs, loss):
    return fw.EpochDraws(*(torch.from_numpy(inputs[f"{loss}_{n}"]) if f"{loss}_{n}" in inputs
                           else None for n in fw.EpochDraws._fields))


def _fast_epochs(inputs, rank, tmp):
    """Each loss's epoch on the mesh; every K1 call's touches must come in
    sorted (the gathered positives and the full batch's user ids)."""
    mesh = make_mesh(n_data=N_DATA, device="cpu")
    touches = {"calls": 0, "unsorted": 0}
    real = fw._sorted_update

    def checked(table, acc, sidx, wg, lr, precision):
        touches["calls"] += 1
        touches["unsorted"] += int((sidx[1:] < sidx[:-1]).sum())
        return real(table, acc, sidx, wg, lr, precision)

    fw._sorted_update = checked
    out = {}
    for loss in LOSSES:
        hp = config.Hyperparams(**_epoch_hp(loss))
        coo = _epoch_coo(loss)
        td = train.build_train_data(coo, np.ones_like(coo.data), identity_rows(EP_USERS),
                                    identity_rows(EP_ITEMS), hp, EP_B, "cpu")
        arrays = {n: inputs[f"{loss}_{n}"] for n in ModelState._fields}
        got = fw.fast_epoch(interop.state_from_numpy(arrays, "cpu"), td,
                            _epoch_draws(inputs, loss), hp, EP_B, mesh=mesh)
        out.update({f"{loss}_{n}": x.numpy() for n, x in zip(ModelState._fields, got)})
    out["k1_calls"] = np.int64(touches["calls"])
    out["k1_unsorted"] = np.int64(touches["unsorted"])
    return out


@pytest.fixture(scope="module")
def fast_epochs(tmp_path_factory, _small_pool):
    inputs, want, single = {}, {}, {}
    jm = jax_parallel.make_mesh(n_data=N_DATA, devices=jax.devices()[:N_DATA])
    for i, loss in enumerate(LOSSES):
        kw = _epoch_hp(loss)
        jhp, thp = jax_config.Hyperparams(**kw), config.Hyperparams(**kw)
        coo = _epoch_coo(loss)
        w = np.ones_like(coo.data)
        jd = jax_train.build_train_data(coo, w, lightfm_tpu.sparse.identity_rows(EP_USERS),
                                        lightfm_tpu.sparse.identity_rows(EP_ITEMS), jhp, EP_B)
        arrays = _random_state(6 + i)
        key = jax.random.key(5 + i)
        draws = _jax_draws(key, jd.packed.shape[1], loss, coo.nnz)
        jstate = jax_parallel.shard_state(JaxState(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                                          jm, "replicated")
        with jm:
            got = jax_train.run_epoch(jstate, jax_parallel.shard_train_data(jd, jm), key, jhp,
                                      EP_B, mesh=jm, fast="einsum")
        want[loss] = {n: np.asarray(x) for n, x in zip(JaxState._fields, got)}
        td = train.build_train_data(coo, w, identity_rows(EP_USERS), identity_rows(EP_ITEMS),
                                    thp, EP_B, "cpu")
        inputs.update({f"{loss}_{n}": np.asarray(v) for n, v in arrays.items()})
        inputs.update({f"{loss}_{n}": v for n, v in draws.items()})
        one = fw.fast_epoch(interop.state_from_numpy(arrays, "cpu"), td,
                            _epoch_draws(inputs, loss), thp, EP_B)
        single[loss] = {n: x.numpy() for n, x in zip(ModelState._fields, one)}
    ranks = launch(SCRIPT, "fast_epochs", tmp_path_factory.mktemp("fast_epochs"), inputs)
    return inputs, want, single, ranks


@pytest.mark.parametrize("loss", LOSSES)
def test_two_rank_fast_epoch_matches_jax_mesh_epoch(fast_epochs, loss):
    inputs, want, single, ranks = fast_epochs
    for name in ("item_table", "item_acc", "user_table", "user_acc"):
        a = ranks[0][f"{loss}_{name}"]
        assert np.array_equal(a, ranks[1][f"{loss}_{name}"]), ("ranks differ", name)
        _assert_close(a, want[loss][name], name)
        _assert_close(a, single[loss][name], ("one device", name))
    assert not np.array_equal(ranks[0][f"{loss}_item_table"], inputs[f"{loss}_item_table"])


def test_gathered_touches_reach_k1_sorted(fast_epochs):
    """Rank r's slice is the data coordinate's contiguous columns of the
    item-sorted batch, so the gathered positives come back sorted."""
    for r in fast_epochs[3]:
        assert r["k1_calls"] == 2 * 3 * len(LOSSES)  # items + users, 3 steps, 3 losses
        assert r["k1_unsorted"] == 0


# ---------------------------------------------------------------------------
# tests/test_fast_warp_mesh.py through LightFM
# ---------------------------------------------------------------------------


def _fast_fits(inputs, rank, tmp):
    from lightfm_tpu_torch.evaluation import auc_score

    fw.POOL_SIZE = POOL
    planted = _planted()
    mesh = make_mesh(n_data=N_DATA, device="cpu")
    out = {}
    m = _tm(loss="warp", mesh=mesh).fit(planted, epochs=1)
    out["engaged"] = np.str_(m._staged_fast)
    m3 = _tm(loss="warp", mesh=mesh, shard_examples=True).fit(planted, epochs=0)
    out["sharded_engaged"] = np.bool_(bool(m3._staged_fast))
    m4 = _tm(loss="warp", mesh=mesh, batch_size=1536).fit(planted, epochs=0)
    out["indivisible_engaged"] = np.bool_(bool(m4._staged_fast))
    for loss in LOSSES:
        m = _tm(loss=loss, mesh=mesh, fast_precision="highest").fit(planted, epochs=1)
        out[f"fast_{loss}"] = np.str_(m._staged_fast)
        for name in ("item_table", "item_acc", "user_table", "user_acc"):
            out[f"{loss}_{name}"] = getattr(m._state, name).numpy()
    m = _tm(loss="warp", mesh=mesh).fit(planted, epochs=5)
    out["auc"] = np.float64(auc_score(m, planted.tocsr(), check_intersections=False).mean())
    for run in range(2):
        out[f"det_{run}"] = _tm(loss="warp", mesh=mesh).fit(planted, epochs=2)._state.item_table.numpy()
    return out


@pytest.fixture(scope="module")
def fast_fits(tmp_path_factory):
    return launch(SCRIPT, "fast_fits", tmp_path_factory.mktemp("fast_fits"))


def test_mesh_fast_path_engages(fast_fits):
    """``tests/test_fast_warp_mesh.py::test_mesh_fast_path_engages``: the
    data-parallel path engages; sharded examples and a batch whose rank
    slice is not whole pools stay on the generic path (so do row- and
    component-split tables: ``tests/test_torch_parallel_partition.py``)."""
    for r in fast_fits:
        assert str(r["engaged"]) == "einsum"
        assert not r["sharded_engaged"] and not r["indivisible_engaged"]


@pytest.mark.parametrize("loss", LOSSES)
def test_mesh_fast_matches_single_chip_one_epoch(fast_fits, loss):
    """At ``fast_precision="highest"``, what the JAX package's DEFAULT is
    on the CPU: at ``"default"`` the bf16 rounding of the candidate scores
    turns a summation-order difference of the pool folds into another
    violator now and then, which no tolerance of f32 order bounds."""
    single = _tm(loss=loss, fast_precision="highest").fit(_planted(), epochs=1)
    assert single._staged_fast == "einsum"
    for r in fast_fits:
        assert str(r[f"fast_{loss}"]) == "einsum"
    for name in ("item_table", "item_acc", "user_table", "user_acc"):
        a = fast_fits[0][f"{loss}_{name}"]
        assert np.array_equal(a, fast_fits[1][f"{loss}_{name}"]), name
        _assert_close(a, getattr(single._state, name).numpy(), name)


def test_mesh_fast_statistical_quality(fast_fits):
    assert fast_fits[0]["auc"] > 0.95
    assert fast_fits[0]["auc"] == fast_fits[1]["auc"]


def test_mesh_fast_deterministic(fast_fits):
    for r in fast_fits:
        assert np.array_equal(r["det_0"], r["det_1"])
    assert np.array_equal(fast_fits[0]["det_0"], fast_fits[1]["det_0"])


def test_mesh_gate_of_the_fast_path():
    """``fast_warp_eligible`` under a mesh (``lightfm_tpu/fast_warp.py:239-260``)."""
    m = _tm(loss="warp").fit(_planted(), epochs=0)
    data, bs = m._staged_train_data, m._staged_batch_size
    hp = config.Hyperparams(loss="warp", no_components=64, fast_path="on")
    one = make_mesh(device="cpu")
    assert fw.fast_warp_eligible(hp, data, one, "global", bs)
    assert not fw.fast_warp_eligible(hp, data, one, "global", bs, table_partition="rows")
    assert not fw.fast_warp_eligible(hp, data, one, "global", bs, shard_examples=True)
    assert not fw.fast_warp_eligible(hp, data, one, "local", bs)
    feats = data._replace(item_feats=lightfm_tpu_torch.sparse.pad_csr(
        sp.identity(8000, format="csr", dtype=np.float32), pad_multiple=8))
    assert fw.fast_warp_eligible(hp, feats, None, "global", bs)
    assert not fw.fast_warp_eligible(hp, feats, one, "global", bs)  # identity only
    with pytest.raises(TypeError):
        fw.fast_warp_eligible(hp, data, object(), "global", bs)


if __name__ == "__main__":
    sys.exit(worker({"fast_epochs": _fast_epochs, "fast_fits": _fast_fits}))
