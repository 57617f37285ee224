"""The port's generic training path vs the JAX package's, on the CPU.

- ``train._shuffle_global`` is bitwise the JAX package's given the same keys.
- One whole generic epoch per configuration runs in both packages with the
  same draws, derived from the epoch's JAX key as ``lightfm_tpu/train.py``
  and ``losses.py`` derive them; every state entry agrees within
  ``1e-4 + 1e-4 * |x|`` (f32 summation order over a whole epoch).
- ``LightFM.fit`` meets the floors of ``tests/test_accuracy_gate.py`` on
  the same synthetic ML-100k twin, trains every loss and schedule within
  0.03 train AUC of the JAX package at the same size (the two packages
  draw different random numbers, so whole fits compare by quality), is
  deterministic per seed, and resumes a mid-fit checkpoint bit-exactly.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import lightfm_tpu
from lightfm_tpu import config as jax_config
from lightfm_tpu import train as jax_train
from lightfm_tpu.datasets import generate_synthetic
from lightfm_tpu.evaluation import auc_score as jax_auc
from lightfm_tpu.state import ModelState as JaxState

import lightfm_tpu_torch
from lightfm_tpu_torch import config, interop, train
from lightfm_tpu_torch.evaluation import auc_score, precision_at_k
from lightfm_tpu_torch.parallel import make_mesh
from lightfm_tpu_torch.sparse import identity_rows, pad_csr
from lightfm_tpu_torch.state import table_width


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _interactions(nu, ni, per_user, seed, signed=False):
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(nu), per_user)
    cols = rng.randint(0, ni, rows.size)
    vals = np.where(rng.rand(rows.size) < 0.3, -1.0, 1.0) if signed else np.ones(rows.size)
    return sp.coo_matrix((vals.astype(np.float32), (rows, cols)), shape=(nu, ni))


def _planted(nu=300, ni=400, per_user=20, d=8, seed=7):
    rng = np.random.RandomState(seed)
    top = np.argsort(-(rng.randn(nu, d) @ rng.randn(ni, d).T), axis=1)[:, :per_user]
    rows = np.repeat(np.arange(nu), per_user)
    return sp.coo_matrix((np.ones(rows.size, np.float32), (rows, top.ravel())), shape=(nu, ni))


def _tm(**kw):
    return lightfm_tpu_torch.LightFM(**{**dict(random_state=10, device="cpu"), **kw})


# ---------------------------------------------------------------------------
# Shuffle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n, batch_size", [(3000, 1024), (4096, 512)])
def test_shuffle_global_matches_jax_bitwise(n, batch_size):
    coo = _interactions(200, 300, n // 200, seed=1, signed=True)
    hp_kw = dict(loss="logistic")
    jd = jax_train.build_train_data(coo, np.ones_like(coo.data),
                                    lightfm_tpu.sparse.identity_rows(200),
                                    lightfm_tpu.sparse.identity_rows(300),
                                    jax_config.Hyperparams(**hp_kw), batch_size)
    td = train.build_train_data(coo, np.ones_like(coo.data), identity_rows(200), identity_rows(300),
                                config.Hyperparams(**hp_kw), batch_size, "cpu")
    n_pad = td.packed.shape[1]
    kperm = jax.random.key(9)
    keys = torch.tensor(np.asarray(jax.random.bits(kperm, (n_pad,), jnp.uint32)).astype(np.int64))
    want = np.asarray(jax_train._shuffle_global(jd.packed, kperm, n_pad // batch_size, batch_size))
    got = train._shuffle_global(td.packed, keys, n_pad // batch_size, batch_size)
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)


def test_shuffle_global_keeps_tied_keys_in_order():
    packed = torch.arange(8 * 12, dtype=torch.int32).reshape(8, 12)
    keys = torch.tensor([5, 1, 5, 1, 0, 5, 2, 2, 0, 1, 5, 0], dtype=torch.int64)
    got = train._shuffle_global(packed, keys, 3, 4)
    order = np.argsort(keys.numpy(), kind="stable")
    assert np.array_equal(got.transpose(0, 1).reshape(8, 12).numpy(), packed.numpy()[:, order])


# ---------------------------------------------------------------------------
# One epoch against the JAX package, same draws
# ---------------------------------------------------------------------------


def _jax_epoch_draws(key, td, jd, hp, batch_size):
    """The draws the JAX package's generic epoch makes from ``key``
    (``train.py:297-299``, ``losses.py:356, 404, 460, 315``), as
    :class:`train.GenericDraws`.  k-OS slots become uniforms that
    ``losses.kos_slots`` maps back to the same integers."""
    n_pad = td.packed.shape[1]
    n_batches = n_pad // batch_size
    kperm, kbatch = jax.random.split(key)
    keys = jax.random.split(kbatch, n_batches)
    perm = torch.tensor(np.asarray(jax.random.bits(kperm, (n_pad,), jnp.uint32)).astype(np.int64))
    shuffled = np.asarray(jax_train._shuffle_global(jd.packed, kperm, n_batches, batch_size))
    n_items = td.item_feats.n_rows
    neg, tries, kos_u = [], [], []
    for b, bkey in enumerate(keys):
        if hp.loss == "warp":
            neg.append(jax.random.randint(bkey, (hp.max_sampled, batch_size), 0, n_items,
                                          dtype=jnp.int32))
        elif hp.loss == "bpr":
            tries.append(jax.random.randint(bkey, (batch_size, hp.bpr_tries), 0,
                                            jd.train_items.shape[0], dtype=jnp.int32))
        elif hp.loss == "warp-kos":
            kpos, kneg = jax.random.split(bkey)
            lens = np.asarray(jd.positives.lengths)[shuffled[b, 0]]
            bound = np.maximum(lens, 1)
            slots = np.asarray(jax.random.randint(kpos, (hp.n, batch_size), 0,
                                                  jnp.asarray(bound)[None, :], dtype=jnp.int32))
            kos_u.append(((slots + 0.5) / bound[None, :]).astype(np.float32))
            neg.append(jax.random.randint(kneg, (hp.max_sampled, batch_size), 0, n_items,
                                          dtype=jnp.int32))

    def stack(xs):
        return torch.tensor(np.stack([np.asarray(x) for x in xs])) if xs else None

    return train.GenericDraws(perm, stack(neg), stack(tries), stack(kos_u))


def _random_arrays(n_items, n_users, D, adadelta, seed):
    rng = np.random.RandomState(seed)
    W = table_width(D)
    out = {}
    for side, n in (("item", n_items), ("user", n_users)):
        t = np.zeros((n, W), np.float32)
        t[:, :D] = rng.randn(n, D) / np.sqrt(D)
        out[f"{side}_table"] = t
        out[f"{side}_acc"] = np.full_like(t, 0.0 if adadelta else 1.0)
        out[f"{side}_mom"] = np.zeros_like(t)
    out["item_log_scale"] = np.float32(0.0)
    out["user_log_scale"] = np.float32(0.0)
    return out


def _tag_csr(n, n_tags=30, seed=2, identity=True):
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n), 3)
    tags = sp.coo_matrix((np.ones(rows.size), (rows, rng.randint(0, n_tags, rows.size))),
                         shape=(n, n_tags))
    if not identity:
        return tags.tocsr().astype(np.float32)
    return sp.hstack([sp.identity(n), tags], format="csr", dtype=np.float32)


EPOCH_CASES = [
    ("logistic", "adagrad", 0.0, False),
    ("warp", "adagrad", 0.0, False),
    ("bpr", "adagrad", 0.0, False),
    ("warp-kos", "adagrad", 0.0, False),
    ("warp", "adadelta", 1e-3, False),
    ("warp", "adagrad", 0.5, False),  # folds mid-epoch (scale past MAX_REG_SCALE)
    ("bpr", "adagrad", 1e-3, True),  # item features
    ("warp-kos", "adadelta", 0.0, False),
    ("warp", "adagrad", 1e-6, "tags"),  # upstream's hybrid model: tags only, item_alpha
]


@pytest.mark.parametrize("loss, schedule, alpha, hybrid", EPOCH_CASES)
def test_one_epoch_matches_jax(loss, schedule, alpha, hybrid):
    nu, ni, B, D = 200, 300, 512, 8
    coo = _interactions(nu, ni, 12, seed=4, signed=(loss == "logistic"))
    w = np.ones_like(coo.data)
    kw = dict(loss=loss, no_components=D, learning_schedule=schedule, item_alpha=alpha,
              user_alpha=alpha, max_sampled=10, bpr_tries=8, n=5, k=2)
    jhp, thp = jax_config.Hyperparams(**kw), config.Hyperparams(**kw)
    if hybrid:
        csr = _tag_csr(ni, identity=hybrid != "tags")
        ji = lightfm_tpu.sparse.pad_csr(csr, pad_multiple=8)
        ti = pad_csr(csr, pad_multiple=8, device="cpu")
    else:
        ji, ti = lightfm_tpu.sparse.identity_rows(ni), identity_rows(ni)
    jd = jax_train.build_train_data(coo, w, lightfm_tpu.sparse.identity_rows(nu), ji, jhp, B)
    td = train.build_train_data(coo, w, identity_rows(nu), ti, thp, B, "cpu")
    arrays = _random_arrays(ti.n_cols, nu, D, schedule == "adadelta", seed=6)

    key = jax.random.key(5)
    draws = _jax_epoch_draws(key, td, jd, thp, B)
    want = jax_train.run_epoch(JaxState(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                               jd, key, jhp, B, fast=False)
    got = train.generic_epoch(interop.state_from_numpy(arrays, "cpu"), td, draws, thp, B)
    for name in JaxState._fields:
        g = getattr(got, name).numpy()
        w_ = np.asarray(getattr(want, name))
        err = np.abs(g - w_) - 1e-4 * np.abs(w_)
        assert (err <= 1e-4).all(), (name, float(err.max()))
    assert not np.array_equal(got.item_table.numpy(), arrays["item_table"])
    assert float(got.item_log_scale) == 0.0  # folded at the epoch's end


def test_maybe_fold_is_bitwise_fold_or_not():
    """The device-side guard equals folding exactly where a scale crossed
    MAX_REG_SCALE and leaves the state bit for bit where none did."""
    from lightfm_tpu_torch.state import LOG_MAX_REG_SCALE, fold_scales, maybe_fold_scales

    s = interop.state_from_numpy(_random_arrays(40, 30, 8, False, seed=1), "cpu")
    low = s._replace(item_log_scale=torch.tensor(LOG_MAX_REG_SCALE - 1e-3),
                     user_log_scale=torch.tensor(0.5))
    high = low._replace(user_log_scale=torch.tensor(LOG_MAX_REG_SCALE + 1e-3))
    for a, b in zip(maybe_fold_scales(low), low):
        assert torch.equal(a, b)
    for a, b in zip(maybe_fold_scales(high), fold_scales(high)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Whole fits
# ---------------------------------------------------------------------------


def _binarize(dataset):
    dataset = dataset.copy().astype(np.float32)
    positives = dataset.data >= 4.0
    dataset.data[positives] = 1.0
    dataset.data[~positives] = -1.0
    return dataset


def _positives(m):
    m = m.tocsr().copy()
    m.data[m.data < 0] = 0.0
    m.eliminate_zeros()
    return m


@pytest.fixture(scope="module")
def ml100k_twin():
    data = generate_synthetic(seed=42)
    return _binarize(data["train"]), _binarize(data["test"])


def test_logistic_floor_gate(ml100k_twin):
    """``tests/test_accuracy_gate.py::test_logistic_floor_gate``'s floors."""
    train_m, test_m = ml100k_twin
    model = _tm()
    model.fit_partial(train_m, epochs=10)
    assert model._staged_fast is False
    tr, te = _positives(train_m), _positives(test_m)
    assert precision_at_k(model, tr).mean() > 0.19
    assert auc_score(model, tr).mean() > 0.71
    assert auc_score(model, te).mean() > 0.66


def test_warp_floor_gate(ml100k_twin):
    """``tests/test_accuracy_gate.py::test_warp_floor_gate``'s floors."""
    train_m, test_m = ml100k_twin
    model = _tm(learning_rate=0.05, loss="warp")
    model.fit_partial(train_m, epochs=10)
    assert model._staged_fast is False
    tr, te = _positives(train_m), _positives(test_m)
    assert precision_at_k(model, tr).mean() > 0.5
    assert precision_at_k(model, te).mean() > 0.06
    assert auc_score(model, tr).mean() > 0.92
    assert auc_score(model, te).mean() > 0.88


@pytest.fixture(scope="module")
def planted():
    return _planted()


@pytest.mark.parametrize("loss", ["logistic", "warp", "bpr", "warp-kos"])
@pytest.mark.parametrize("schedule, alpha",
                         [("adagrad", 0.0), ("adadelta", 0.0), ("adagrad", 1e-4)])
def test_whole_fit_matches_jax_statistically(planted, loss, schedule, alpha):
    """10 epochs at D = 16 on a planted set, through each package's own
    ``fit`` and ``auc_score``: train AUC within 0.03."""
    kw = dict(loss=loss, learning_schedule=schedule, no_components=16, item_alpha=alpha,
              user_alpha=alpha, random_state=3, fast_path="off")
    if loss == "logistic":
        kw["learning_rate"] = 0.1
    tm = _tm(**kw).fit(planted, epochs=10)
    assert tm._staged_fast is False
    jm = lightfm_tpu.LightFM(**kw).fit(planted, epochs=10)
    csr = planted.tocsr()
    port = float(auc_score(tm, csr).mean())
    ref = float(np.asarray(jax_auc(jm, csr)).mean())
    assert np.isfinite(port) and abs(port - ref) <= 0.03, (port, ref)
    assert port > 0.6


@pytest.mark.parametrize("kw", [dict(loss="warp-kos", item_alpha=1e-3),
                                dict(loss="bpr", learning_schedule="adadelta")])
def test_generic_fit_is_deterministic(planted, kw):
    runs = [_tm(random_state=42, **kw).fit(planted, epochs=2)._state for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fast_path", ["on", "off", "auto"])
def test_every_fast_path_setting_trains(planted, fast_path):
    """``fast_path`` "on" and "auto" fall back to the generic path where the
    fast gate turns the configuration down (here: a small item table)."""
    m = _tm(loss="warp", fast_path=fast_path).fit(planted, epochs=3)
    assert m._staged_fast is False
    assert float(auc_score(m, planted.tocsr()).mean()) > 0.75


# ---------------------------------------------------------------------------
# Mid-fit checkpoints (tests/test_checkpoint.py:155-206)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("verbose", [False, True])
def test_midfit_checkpoint_kill_and_resume(planted, tmp_path, verbose):
    """A run checkpointed every 2 epochs and cut after 4 of 6 resumes from
    disk to the uninterrupted run's state, bit for bit."""
    kw = dict(loss="warp", item_alpha=1e-4, random_state=11)
    path_full = str(tmp_path / "full.npz")
    full = _tm(**kw).fit(planted, epochs=6, checkpoint_every_n_epochs=2,
                         checkpoint_path=path_full, verbose=verbose)
    path_part = str(tmp_path / "part.npz")
    part = _tm(**kw).fit(planted, epochs=4, checkpoint_every_n_epochs=2,
                         checkpoint_path=path_part, verbose=verbose)
    del part
    resumed = lightfm_tpu_torch.load_model(path_part, device="cpu")
    resumed.fit_partial(planted, epochs=2, checkpoint_every_n_epochs=2, checkpoint_path=path_part,
                        verbose=verbose)
    for a, b in zip(resumed._state, full._state):
        assert torch.equal(a, b)
    a = lightfm_tpu_torch.load_model(path_part, device="cpu")
    b = lightfm_tpu_torch.load_model(path_full, device="cpu")
    assert torch.equal(a._state.item_table, b._state.item_table)
    assert np.array_equal(a.random_state.randint(0, 1 << 30, 16),
                          b.random_state.randint(0, 1 << 30, 16))
    assert not (tmp_path / "full.npz.tmp").exists()


def test_midfit_checkpoint_matches_a_plain_fit(planted, tmp_path):
    """Seeds drawn per chunk follow the same RandomState stream as seeds
    drawn all at once, so the checkpointed fit equals the plain one."""
    plain = _tm(loss="bpr", random_state=5).fit(planted, epochs=3)
    chunked = _tm(loss="bpr", random_state=5).fit(
        planted, epochs=3, checkpoint_every_n_epochs=2, checkpoint_path=str(tmp_path / "c.npz"))
    for a, b in zip(plain._state, chunked._state):
        assert torch.equal(a, b)


def test_midfit_checkpoint_validation(planted, tmp_path):
    m = _tm(loss="warp")
    with pytest.raises(ValueError, match="checkpoint_path"):
        m.fit(planted, epochs=2, checkpoint_every_n_epochs=1)
    with pytest.raises(ValueError, match="must be >= 1"):
        m.fit(planted, epochs=2, checkpoint_every_n_epochs=0, checkpoint_path=str(tmp_path / "x"))
    split = _tm(mesh=make_mesh(device="cpu"), table_partition="components")
    split.fit(planted, epochs=2, checkpoint_every_n_epochs=1, checkpoint_path=str(tmp_path / "c"))
    assert split._placement.item.layout == "components"
    with pytest.raises(TypeError):
        _tm(mesh=object()).fit(planted, epochs=1)


def test_midfit_checkpoint_loads_in_jax(planted, tmp_path):
    path = str(tmp_path / "port.npz")
    tm = _tm(loss="warp-kos", learning_schedule="adadelta").fit(
        planted, epochs=2, checkpoint_every_n_epochs=1, checkpoint_path=path)
    jm = lightfm_tpu.load_model(path)
    for name in JaxState._fields:
        assert np.array_equal(np.asarray(getattr(jm._state, name)),
                              getattr(tm._state, name).numpy()), name
    u = np.arange(50)
    np.testing.assert_allclose(jm.predict(u, u), tm.predict(u, u), rtol=1e-5, atol=1e-6)
    jm.fit_partial(planted, epochs=1)  # the JAX package trains on from it
    assert np.isfinite(np.asarray(jm._state.item_table)).all()


@pytest.mark.parametrize("loss", ["logistic", "warp", "bpr", "warp-kos"])
def test_generic_epoch_never_reads_a_value_back(loss, monkeypatch):
    """No step of a generic epoch (lazy L2 on, so the fold guard runs after
    every step) turns a tensor into a host value: on the card each would
    stop the host until the device caught up."""
    coo = _interactions(150, 200, 10, seed=2)
    hp = config.Hyperparams(loss=loss, no_components=8, item_alpha=0.5, user_alpha=0.5)
    td = train.build_train_data(coo, np.ones_like(coo.data), identity_rows(150),
                                identity_rows(200), hp, 256, "cpu")
    draws = train.draw_generic_epoch(torch.Generator().manual_seed(0), td, hp, 256)
    state = interop.state_from_numpy(_random_arrays(200, 150, 8, False, seed=3), "cpu")

    def refuse(*a, **k):
        raise AssertionError("a tensor was read back to the host")

    for name in ("item", "tolist", "__bool__", "__float__", "__int__", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    out = train.generic_epoch(state, td, draws, hp, 256)
    monkeypatch.undo()
    assert all(bool(torch.isfinite(x).all()) for x in out)
