"""lightfm_tpu_torch.fast_warp vs lightfm_tpu.fast_warp, on the CPU.

The port cannot reproduce ``jax.random``, so its shuffle, steps and epoch
take their random draws as inputs; here the draws are derived from a JAX
key exactly as the JAX package derives them (``fast_warp.py:313, 828,
837-838, 939-942, 1063-1064``) and both packages run the same work.

Tolerances: the shuffle is compared bitwise.  Steps and epochs run at
``fast_precision="highest"`` (the JAX package ignores DEFAULT on the CPU)
and agree to f32 summation order: ``|got - want| <= 1e-5 + 1e-5 * |want|``
on every table and accumulator entry (updates are O(lr * MAX_LOSS); both
packages sum the same terms in different orders).
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
from lightfm_tpu.state import ModelState as JaxState

import lightfm_tpu_torch
from lightfm_tpu_torch import config, fast_warp as fw, interop, train
from lightfm_tpu_torch.evaluation import auc_score
from lightfm_tpu_torch.parallel import make_mesh
from lightfm_tpu_torch.sparse import identity_rows
from lightfm_tpu_torch.state import table_width


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    worker processes side by side, and each one's OpenMP pool spinning on
    every core slows all of them by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planted(nu=1500, ni=8000, per_user=30, d=16, seed=7):
    rng = np.random.RandomState(seed)
    U = rng.randn(nu, d)
    V = rng.randn(ni, d)
    top = np.argsort(-(U @ V.T), axis=1)[:, :per_user]
    rows = np.repeat(np.arange(nu), per_user)
    return sp.coo_matrix(
        (np.ones(len(rows), np.float32), (rows, top.ravel())), shape=(nu, ni)
    )


@pytest.fixture(scope="module")
def planted():
    return _planted()


@pytest.fixture(autouse=True)
def _force_fast_path(monkeypatch):
    """"auto" engages on CUDA only; force the fast path on the CPU, with
    the env var both packages read at fit time."""
    monkeypatch.setenv("LIGHTFM_TPU_FAST_WARP", "1")


def _tm(**kw):
    return lightfm_tpu_torch.LightFM(
        **{**dict(loss="warp", no_components=64, random_state=10, device="cpu"), **kw}
    )


# ---------------------------------------------------------------------------
# Draws derived from a JAX key, as the JAX package draws them
# ---------------------------------------------------------------------------


def _jax_draws(key, n_pad, batch_size, loss, mode, n_items=0, n_examples=0, K=0):
    kperm, kbatch = jax.random.split(key)
    keys = jax.random.split(kbatch, n_pad // batch_size)
    n_perm = n_pad if mode == "sort" else 4
    perm = torch.tensor(np.asarray(jax.random.bits(kperm, (n_perm,), jnp.uint32)).astype(np.int64))
    if loss == "logistic":
        return fw.EpochDraws(perm, None, None), keys
    P = min(fw.POOL_SIZE, batch_size)
    high = n_examples if loss == "bpr" else n_items
    pools, shifts = [], []
    for bkey in keys:
        kp, kr = jax.random.split(bkey)
        pools.append(np.asarray(jax.random.randint(kp, (P,), 0, high, dtype=jnp.int32)))
        shifts.append(np.asarray(jax.random.randint(kr, (K,), 0, P, dtype=jnp.int32)))
    return (
        fw.EpochDraws(perm, torch.tensor(np.stack(pools)), torch.tensor(np.stack(shifts))),
        keys,
    )


def _jax_state(arrays):
    return JaxState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _random_state(n_items, n_users, D, seed):
    rng = np.random.RandomState(seed)
    W = table_width(D)

    def table(n):
        t = np.zeros((n, W), np.float32)
        t[:, :D] = rng.randn(n, D) / np.sqrt(D)
        t[:, -1] = 0.1 * rng.randn(n)
        return t

    it, ut = table(n_items), table(n_users)
    return {
        "item_table": it, "item_acc": (1 + rng.rand(*it.shape)).astype(np.float32),
        "item_mom": np.zeros_like(it), "user_table": ut,
        "user_acc": (1 + rng.rand(*ut.shape)).astype(np.float32),
        "user_mom": np.zeros_like(ut),
        "item_log_scale": np.float32(0), "user_log_scale": np.float32(0),
    }


def _assert_states_close(got, want):
    for name in ("item_table", "item_acc", "user_table", "user_acc"):
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        err = np.abs(g - w) - 1e-5 * np.abs(w)
        assert (err <= 1e-5).all(), (name, float(err.max()))


def _interactions(nu, ni, per_user, seed, signed=False):
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(nu), per_user)
    cols = rng.randint(0, ni, rows.size)
    vals = np.where(rng.rand(rows.size) < 0.3, -1.0, 1.0) if signed else np.ones(rows.size)
    coo = sp.coo_matrix((vals.astype(np.float32), (rows, cols)), shape=(nu, ni))
    coo.sum_duplicates()
    coo.data = np.sign(coo.data).astype(np.float32)
    coo.eliminate_zeros()
    return coo


def _both_data(coo, loss, batch_size, weights=None):
    kw = dict(loss=loss, no_components=8, fast_precision="highest")
    w = np.ones_like(coo.data) if weights is None else weights
    nu, ni = coo.shape
    jd = jax_train.build_train_data(
        coo, w, lightfm_tpu.sparse.identity_rows(nu), lightfm_tpu.sparse.identity_rows(ni),
        jax_config.Hyperparams(**kw), batch_size,
    )
    td = train.build_train_data(
        coo, w, identity_rows(nu), identity_rows(ni), config.Hyperparams(**kw),
        batch_size, "cpu",
    )
    return jd, td


# ---------------------------------------------------------------------------
# Shuffle
# ---------------------------------------------------------------------------


def test_feistel_matches_jax_bitwise_at_the_production_shape():
    """39 batches x 131,072, the seeds that broke the unfixed round
    function (tests/test_fast_warp.py:164) and others: bitwise equal to JAX
    and exactly balanced."""
    n_batches, batch_size = 39, 131072
    n = n_batches * batch_size
    fn = jax.jit(jax_fw._feistel_batch_of, static_argnums=(0, 1))
    for seed in (410, 1554, 2204, 0):
        key = jax.random.key(seed)
        want = np.asarray(fn(n, n_batches, key))
        ks = np.asarray(jax.random.bits(key, (4,), jnp.uint32)).astype(np.int64)
        got = fw._feistel_batch_of(n, n_batches, torch.tensor(ks)).numpy()
        assert np.array_equal(got, want), seed
        assert (np.bincount(got, minlength=n_batches) == batch_size).all(), seed


def test_hash_u32_matches_jax_on_extreme_values():
    x = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 0x85EBCA6B, 12345], np.uint32)
    for k in (0, 1, 2**32 - 1, 0xDEADBEEF):
        want = np.asarray(jax_fw._hash_u32(jnp.asarray(x), jnp.uint32(k)))
        got = fw._hash_u32(torch.tensor(x.astype(np.int64)), torch.tensor(k))
        assert np.array_equal(got.numpy().astype(np.uint32), want), k


@pytest.mark.parametrize("mode", ["feistel", "sort"])
def test_shuffle_item_sorted_matches_jax_and_keeps_invariants(mode):
    rng = np.random.RandomState(0)
    n, B = 4096, 512
    n_batches = n // B
    users = rng.randint(0, 300, n).astype(np.int32)
    items = rng.randint(0, 500, n).astype(np.int32)
    packed = np.zeros((8, n), dtype=np.int32)
    packed[0], packed[1] = users, items
    packed[2] = np.arange(n)  # unique tag to track the permutation
    packed[3], packed[4] = 7, 1
    key = jax.random.key(3)
    want = jax.jit(jax_fw.shuffle_item_sorted, static_argnums=(2, 3, 4))(
        jnp.asarray(packed), key, n_batches, B, mode
    )
    n_perm = n if mode == "sort" else 4
    perm = torch.tensor(np.asarray(jax.random.bits(key, (n_perm,), jnp.uint32)).astype(np.int64))
    got = fw.shuffle_item_sorted(torch.tensor(packed), perm, n_batches, B, mode)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))

    shuffled, suid, sigma = (x.numpy() for x in got)
    assert sorted(shuffled[:, 2, :].ravel().tolist()) == list(range(n))
    for b in range(n_batches):
        ib, ub, tag = shuffled[b, 1], shuffled[b, 0], shuffled[b, 2]
        assert (np.diff(ib) >= 0).all()
        assert (items[tag] == ib).all() and (users[tag] == ub).all()
        assert (np.diff(suid[b]) >= 0).all()
        assert sorted(sigma[b].tolist()) == list(range(B))
        assert (ub[sigma[b]] == suid[b]).all()


def test_unpack_batch5_matches_jax():
    packed = np.zeros((5, 6), np.int32)
    packed[0], packed[1] = np.arange(6), np.arange(6)[::-1]
    packed[2] = np.array([1.0, -1.0, 0.5, 0.0, 2.0, 3.0], np.float32).view(np.int32)
    packed[3] = np.array([1.0, 0.0, 0.25, 1.0, 1.0, 5.0], np.float32).view(np.int32)
    packed[4] = [1, 1, 0, 1, 0, 1]
    got = fw._unpack_batch5(torch.tensor(packed))
    want = jax_fw._unpack_batch5(jnp.asarray(packed))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# Steps and epochs against JAX, same draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "loss, B, D, user_pallas",
    [
        ("warp", 1024, 16, True),
        ("warp", 32768, 8, True),  # P = 16384, Q = 2: the pool fold across rows
        ("warp", 1024, 16, False),
        ("bpr", 1024, 16, True),
        ("bpr", 32768, 8, False),
        ("logistic", 1024, 16, True),
        ("logistic", 1024, 16, False),
    ],
)
def test_one_step_matches_jax(loss, B, D, user_pallas):
    nu, ni = 900, 3000
    coo = _interactions(nu, ni, max(4, B // nu + 3), seed=1, signed=(loss == "logistic"))
    jd, td = _both_data(coo, loss, B)
    n_pad = td.packed.shape[1]
    kw = dict(loss=loss, no_components=D, fast_precision="highest", user_pallas=user_pallas,
              max_sampled=10, bpr_tries=8, learning_rate=0.07)
    jhp, thp = jax_config.Hyperparams(**kw), config.Hyperparams(**kw)
    draws, keys = _jax_draws(jax.random.key(11), n_pad, B, loss, "feistel",
                             n_items=ni, n_examples=coo.nnz,
                             K=10 if loss == "warp" else 8)
    shuffled, suid, sigma = fw.shuffle_item_sorted(td.packed, draws.perm, n_pad // B, B)
    arrays = _random_state(ni, nu, D, seed=2)
    tstate = interop.state_from_numpy(arrays, "cpu")
    jstate = _jax_state(arrays)
    tb = fw._unpack_batch5(shuffled[0])
    jb = jax_fw._unpack_batch5(jnp.asarray(shuffled[0].numpy()))
    js, jg = jnp.asarray(suid[0].numpy()), jnp.asarray(sigma[0].numpy())
    if loss == "warp":
        want = jax_fw.warp_pool_step(jstate, jb, jd.positives, js, jg, jhp, keys[0],
                                     n_items=ni, use_pallas=False, user_pallas=user_pallas)
        got = fw.warp_pool_step(tstate, tb, td.positives, suid[0], sigma[0], thp,
                                draws.pool[0], draws.shifts[0], n_items=ni,
                                user_pallas=user_pallas)
    elif loss == "bpr":
        want = jax_fw.bpr_pool_step(jstate, jb, jd.positives, jd.train_items, js, jg, jhp,
                                    keys[0], n_items=ni, use_pallas=False,
                                    user_pallas=user_pallas)
        got = fw.bpr_pool_step(tstate, tb, td.positives, td.train_items, suid[0], sigma[0],
                               thp, draws.pool[0], draws.shifts[0], user_pallas=user_pallas)
    else:
        want = jax_fw.logistic_sorted_step(jstate, jb, js, jg, jhp, use_pallas=False,
                                           user_pallas=user_pallas)
        got = fw.logistic_sorted_step(tstate, tb, suid[0], sigma[0], thp,
                                      user_pallas=user_pallas)
    assert got is tstate  # in place
    _assert_states_close(got, want)
    # The step really moved the tables.
    assert not np.array_equal(got.item_table.numpy(), arrays["item_table"])
    assert not np.array_equal(got.user_table.numpy(), arrays["user_table"])


@pytest.mark.parametrize(
    "loss, mode", [("warp", "feistel"), ("warp", "sort"), ("bpr", "feistel"), ("logistic", "feistel")]
)
def test_one_epoch_matches_jax(loss, mode):
    nu, ni, B, D = 400, 2500, 1024, 16
    coo = _interactions(nu, ni, 15, seed=4, signed=(loss == "logistic"))
    jd, td = _both_data(coo, loss, B)
    kw = dict(loss=loss, no_components=D, fast_precision="highest", shuffle_mode=mode,
              max_sampled=10, bpr_tries=8)
    jhp, thp = jax_config.Hyperparams(**kw), config.Hyperparams(**kw)
    key = jax.random.key(5)
    draws, _ = _jax_draws(key, td.packed.shape[1], B, loss, mode, n_items=ni,
                          n_examples=coo.nnz, K=10 if loss == "warp" else 8)
    arrays = _random_state(ni, nu, D, seed=6)
    want = jax_fw.fast_epoch(_jax_state(arrays), jd, key, jhp, B)
    got = fw.fast_epoch(interop.state_from_numpy(arrays, "cpu"), td, draws, thp, B)
    _assert_states_close(got, want)


def _bf16_np(x):
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("eq, sa, sb", [
    ("qsd,ksd->kqs", (2, 64, 24), (5, 64, 24)),
    ("kqs,ksd->qsd", (5, 2, 64), (5, 64, 24)),
    ("kqs,qsd->ksd", (5, 2, 64), (2, 64, 24)),
])
def test_default_precision_contractions_use_bf16_operands(eq, sa, sb):
    """``"default"``: bf16-rounded operands, fp32 sums -- against numpy
    float64 on the rounded operands; tolerance 2^-22 x the sum of |terms|
    (depth <= 24 fp32 additions)."""
    rng = np.random.RandomState(0)
    a = rng.randn(*sa).astype(np.float32)
    b = rng.randn(*sb).astype(np.float32)
    got = fw._einsum(eq, torch.tensor(a), torch.tensor(b), "default").numpy()
    ra, rb = _bf16_np(a).astype(np.float64), _bf16_np(b).astype(np.float64)
    want = np.einsum(eq, ra, rb)
    bound = np.einsum(eq, np.abs(ra), np.abs(rb)) * 2.0 ** -22 * 24
    assert (np.abs(got - want) <= bound).all()
    exact = np.einsum(eq, a.astype(np.float64), b.astype(np.float64))
    assert np.abs(got - exact).max() > 1e-4  # the rounding is really applied
    highest = fw._einsum(eq, torch.tensor(a), torch.tensor(b), "highest").numpy()
    assert (np.abs(highest - exact) <= np.einsum(eq, np.abs(a), np.abs(b)) * 2.0 ** -22 * 24).all()


# ---------------------------------------------------------------------------
# Eligibility, no-ops, determinism (tests/test_fast_warp.py, identity cases)
# ---------------------------------------------------------------------------


def test_eligibility_gate(planted, monkeypatch):
    m = _tm()
    m.fit(planted, epochs=1)
    assert m._staged_fast == "einsum"
    assert _tm(loss="logistic").fit(planted, epochs=0)._staged_fast
    assert _tm(loss="bpr").fit(planted, epochs=0)._staged_fast

    data, bs = m._staged_train_data, m._staged_batch_size
    base = dict(loss="warp", no_components=64)
    for kw in (
        dict(loss="warp-kos"),
        dict(learning_schedule="adadelta"),
        dict(item_alpha=1e-5),
        dict(user_alpha=1e-5),
        dict(no_components=4),  # table under MIN_TABLE_ELEMS
    ):
        hp = config.Hyperparams(**{**base, **kw})
        assert not fw.fast_warp_eligible(hp, data, None, "global", bs), kw
        # Off the fast path, fit trains on the generic path, as the JAX
        # package's does.
        _assert_generic_like_jax(planted, **kw)
    hp = config.Hyperparams(**base)
    with pytest.raises(TypeError):  # a mesh is a lightfm_tpu_torch.parallel.Mesh
        fw.fast_warp_eligible(hp, data, object(), "global", bs)
    assert not fw.fast_warp_eligible(hp, data, make_mesh(device="cpu"), "global", bs,
                                     table_partition="rows")
    assert not fw.fast_warp_eligible(hp, data, None, "local", bs)
    assert not fw.fast_warp_eligible(hp, data, None, "global", 3 * fw.POOL_SIZE // 2)
    # "auto" engages on CUDA devices only.
    assert not fw.fast_warp_eligible(config.Hyperparams(**base, fast_path="auto"),
                                     data, None, "global", bs)
    assert fw.fast_warp_eligible(config.Hyperparams(**base, fast_path="on"),
                                 data, None, "global", bs)
    assert not fw.fast_warp_eligible(config.Hyperparams(**base, fast_path="off"),
                                     data, None, "global", bs)
    monkeypatch.delenv("LIGHTFM_TPU_FAST_WARP")
    for fast_path in ("auto", "off"):  # on the CPU neither engages
        _assert_generic_like_jax(planted, fast_path=fast_path)


def _user_sample(coo, n=300):
    """The first ``n`` users' rows (others emptied), so AUC ranks only them."""
    csr = coo.tocsr()
    keep = np.zeros(csr.shape[0], np.float32)
    keep[:n] = 1.0
    out = sp.diags(keep).dot(csr).tocsr()
    out.eliminate_zeros()
    return out


def _assert_generic_like_jax(data, item_features=None, **kw):
    """One epoch of ``fit`` takes the generic path, leaves a finite state
    and lands within 0.03 sample AUC of the JAX package's fit of the same
    configuration (each package's own ``auc_score``)."""
    tm = _tm(**kw).fit(data, epochs=1, item_features=item_features)
    assert tm._staged_fast is False, kw
    assert all(bool(torch.isfinite(x).all()) for x in tm._state), kw
    jkw = {**dict(loss="warp", no_components=64, random_state=10), **kw}
    jm = lightfm_tpu.LightFM(**jkw).fit(data, epochs=1, item_features=item_features)
    assert jm._staged_fast is False, kw
    sample = _user_sample(data)
    port = float(auc_score(tm, sample, item_features=item_features).mean())
    ref = float(np.asarray(jax_auc(jm, sample, item_features=item_features)).mean())
    assert abs(port - ref) <= 0.03, (kw, port, ref)


def test_out_of_slice_configurations_raise(planted):
    """Configurations the fast path turns down train on the generic path, a
    mesh's row partition among them, and a mesh that is not a ``Mesh``
    raises ``TypeError``."""
    def tags(density):
        return sp.hstack([sp.identity(8000, dtype=np.float32, format="csr"),
                          sp.random(8000, 50, density=density, format="csr",
                                    dtype=np.float32, random_state=0)], format="csr")

    # Hybrid WARP/BPR train on the fast path; hybrid logistic and feature
    # rows wider than MAX_FAST_FEAT_NNZ on the generic path.
    _assert_generic_like_jax(planted, item_features=tags(0.05), loss="logistic")
    _assert_generic_like_jax(planted, item_features=tags(0.5))
    rows = _tm(mesh=make_mesh(device="cpu"), table_partition="rows", fast_path="on")
    assert rows.fit(planted, epochs=1)._staged_fast is False
    assert rows._placement.item.layout == "rows"
    with pytest.raises(TypeError):
        _tm(mesh=object()).fit(planted, epochs=1)


def test_fast_step_invalid_rows_are_noops(planted):
    coo = planted.copy()
    coo.data = -np.ones_like(coo.data)  # y <= 0 -> warp skips (template:831)
    m = _tm()
    m.fit(coo, epochs=0)
    before = m._state
    kept = {n: x.clone() for n, x in zip(before._fields, before)}
    after = train.run_epochs(before, m._staged_train_data, [1], m._staged_hp,
                             m._staged_batch_size, fast=m._staged_fast)
    for name in ("item_table", "user_table", "item_acc", "user_acc"):
        assert torch.equal(getattr(after, name), kept[name]), name
        assert torch.equal(getattr(before, name), kept[name]), name  # not mutated


def test_zero_sample_weights_are_noops(planted):
    m = _tm()
    m.fit(planted, epochs=0)
    before = {n: x.clone() for n, x in zip(m._state._fields, m._state)}
    zero_w = planted.copy()
    zero_w.data = np.zeros_like(zero_w.data)
    m.fit_partial(planted, sample_weight=zero_w.tocoo(), epochs=2)
    assert m._staged_fast
    assert torch.equal(m._state.item_table, before["item_table"])
    assert torch.equal(m._state.user_table, before["user_table"])


def test_max_sampled_zero_epoch_is_a_noop(planted):
    m = _tm()
    m.fit(planted, epochs=0)
    before = m._state.item_table.clone()
    m.max_sampled = 0
    m.fit_partial(planted, epochs=2)
    assert torch.equal(m._state.item_table, before)


@pytest.mark.parametrize("kw", [{}, dict(shuffle_mode="sort", user_pallas=False)])
def test_fast_path_deterministic(planted, kw):
    runs = []
    for _ in range(2):
        m = _tm(random_state=42, **kw)
        m.fit(planted, epochs=2)
        assert m._staged_fast
        runs.append(m._state)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_run_epochs_leaves_the_callers_state_alone(planted):
    m = _tm()
    m.fit(planted, epochs=0)
    kept = m._state.item_table.clone()
    out = train.run_epochs(m._state, m._staged_train_data, [3], m._staged_hp,
                           m._staged_batch_size, fast=m._staged_fast)
    assert torch.equal(m._state.item_table, kept)
    assert not torch.equal(out.item_table, kept)


def test_env_override_value_parsing(monkeypatch):
    for var in ("LIGHTFM_TPU_FAST_WARP", "LIGHTFM_TPU_POOL_KERNELS",
                "LIGHTFM_TPU_FAST_WARP_USER_PALLAS",
                "LIGHTFM_TPU_FAST_WARP_PRECISION", "LIGHTFM_TPU_FAST_SHUFFLE"):
        monkeypatch.setenv(var, "")
    assert fw.env_override_fields() == jax_fw.env_override_fields() == {}
    for raw, want in (("false", False), ("ON", True)):
        monkeypatch.setenv("LIGHTFM_TPU_FAST_WARP_USER_PALLAS", raw)
        assert fw.env_override_fields() == jax_fw.env_override_fields() == {"user_pallas": want}
    monkeypatch.setenv("LIGHTFM_TPU_FAST_WARP_USER_PALLAS", "maybe")
    with pytest.raises(ValueError, match="USER_PALLAS"):
        fw.env_override_fields()
    monkeypatch.setenv("LIGHTFM_TPU_FAST_WARP_USER_PALLAS", "")
    monkeypatch.setenv("LIGHTFM_TPU_FAST_WARP", "0")
    assert fw.env_override_fields() == {"fast_path": "off"}
    monkeypatch.setenv("LIGHTFM_TPU_FAST_WARP_PRECISION", "highest")
    hp = fw.apply_env_overrides(_tm()._hp())
    assert hp.fast_path == "off" and hp.fast_precision == "highest"
    monkeypatch.setenv("LIGHTFM_TPU_FAST_WARP", "sometimes")
    with pytest.raises(ValueError, match="fast_path"):
        fw.apply_env_overrides(_tm()._hp())


def test_deprecated_pool_kernels_alias_warns(planted):
    with pytest.warns(UserWarning, match="removed"):
        m = _tm(pool_kernels="kernels").fit(planted, epochs=0)
    assert m._staged_fast == "einsum"


def test_fit_trains_and_tracks_stats(planted):
    m = _tm(loss="warp")
    m.fit(planted, epochs=3, verbose=True)
    assert m.fit_stats_.epochs == 3 and m.fit_stats_.examples_per_sec > 0
    assert float(auc_score(m, planted.tocsr()).mean()) > 0.9


def test_fitted_model_pickles_without_its_staged_data(planted):
    import pickle

    m = _tm().fit(planted, epochs=1)
    again = pickle.loads(pickle.dumps(m))
    assert not hasattr(again, "_staged_train_data")
    assert torch.equal(again._state.item_table, m._state.item_table)
    u = np.arange(20)
    assert np.array_equal(again.predict(u, u), m.predict(u, u))
