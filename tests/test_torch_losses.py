"""lightfm_tpu_torch.losses vs lightfm_tpu.losses, one step at a time, on the CPU.

The port cannot reproduce ``jax.random``, so its steps take their draws as
integer tensors; here they are derived from the JAX step's own key exactly
as ``lightfm_tpu/losses.py`` draws them (WARP ``:356``, BPR ``:404``, k-OS
``:460`` and ``:315``).  One step of each loss then runs from the same
state and batch in both packages, over identity, padded and chunked
feature matrices, adagrad and adadelta, with lazy L2 on and off.  Every
state entry agrees within ``1e-5 + 1e-5 * |x|`` (f32 summation order).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import lightfm_tpu
from lightfm_tpu import config as jax_config
from lightfm_tpu import losses as jax_losses
from lightfm_tpu import train as jax_train
from lightfm_tpu.state import ModelState as JaxState

from lightfm_tpu_torch import config, interop, losses, train
from lightfm_tpu_torch.fast_warp import _unpack_batch5
from lightfm_tpu_torch.sparse import ChunkedRows, PaddedRows, identity_rows, pad_csr
from lightfm_tpu_torch.state import table_width

NU, NI, B, D = 150, 240, 256, 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def interactions(signed: bool, seed: int = 0):
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(NU), 10)
    rows[:40] = 0  # a heavy user; users 1..3 have no interactions
    cols = rng.randint(0, NI, rows.size)
    vals = np.where(rng.rand(rows.size) < 0.3, -1.0, 1.0) if signed else np.ones(rows.size)
    coo = sp.coo_matrix((vals.astype(np.float32), (rows, cols)), shape=(NU, NI))
    return coo


def features(kind: str, n: int, seed: int):
    """CSR feature matrices: identity; identity + up to 4 tags a row; and
    the same with 3 rows of about 300 tags over a p99 of 8, which spill
    into three overflow chunks of 128."""
    if kind == "identity":
        return None
    rng = np.random.RandomState(seed)
    n_tags = 400
    rows = np.repeat(np.arange(n), 4)
    cols = rng.randint(0, n_tags, rows.size)
    if kind == "chunked":
        heavy = [rng.choice(n_tags, 300, replace=False) for _ in range(3)]
        rows = np.concatenate([rows, np.repeat([2, 7, 11], 300)])
        cols = np.concatenate([cols] + heavy)
    vals = rng.choice([0.5, 1.0], rows.size)
    tags = sp.coo_matrix((vals, (rows, cols)), shape=(n, n_tags))
    return sp.hstack([sp.identity(n), tags], format="csr", dtype=np.float32)


def padded_both(csr, n):
    """The JAX package's and the port's padded structure of ``csr`` (the
    width cap that ``LightFM._pad_features`` would pick for it)."""
    if csr is None:
        return lightfm_tpu.sparse.identity_rows(n), identity_rows(n)
    kw = dict(pad_multiple=8, width_cap=8, chunk_width=128)
    return lightfm_tpu.sparse.pad_csr(csr, **kw), pad_csr(csr, device="cpu", **kw)


def jax_draws(loss, key, hp, uid_lens, n_examples):
    """The draws the JAX step makes from ``key``, as the port takes them."""
    if loss == "warp":
        return torch.tensor(np.asarray(
            jax.random.randint(key, (hp.max_sampled, B), 0, NI, dtype=jnp.int32)))
    if loss == "bpr":
        return torch.tensor(np.asarray(
            jax.random.randint(key, (B, hp.bpr_tries), 0, n_examples, dtype=jnp.int32)))
    if loss == "warp-kos":
        kpos, kneg = jax.random.split(key)
        slots = jax.random.randint(kpos, (hp.n, B), 0, jnp.maximum(uid_lens, 1)[None, :],
                                   dtype=jnp.int32)
        neg = jax.random.randint(kneg, (hp.max_sampled, B), 0, NI, dtype=jnp.int32)
        return torch.tensor(np.asarray(slots)), torch.tensor(np.asarray(neg))
    return None


def random_state(n_item_rows, n_user_rows, adadelta, lazy, seed):
    rng = np.random.RandomState(seed)
    W = table_width(D)
    out = {}
    for side, n in (("item", n_item_rows), ("user", n_user_rows)):
        t = np.zeros((n, W), np.float32)
        t[:, :D] = rng.randn(n, D) / np.sqrt(D)
        t[:, -1] = 0.1 * rng.randn(n)
        out[f"{side}_table"] = t
        if adadelta:
            out[f"{side}_acc"] = (0.2 * rng.rand(*t.shape)).astype(np.float32)
            out[f"{side}_mom"] = (0.01 * rng.rand(*t.shape)).astype(np.float32)
        else:
            out[f"{side}_acc"] = (1 + rng.rand(*t.shape)).astype(np.float32)
            out[f"{side}_mom"] = np.zeros_like(t)
    out["item_log_scale"] = np.float32(0.3 if lazy else 0.0)
    out["user_log_scale"] = np.float32(0.2 if lazy else 0.0)
    return out


def staged(loss, feats, hp_kw):
    coo = interactions(signed=(loss == "logistic"))
    w = np.ones_like(coo.data)
    ju, tu = padded_both(features(feats, NU, 1), NU)
    ji, ti = padded_both(features(feats, NI, 2), NI)
    jhp, thp = jax_config.Hyperparams(**hp_kw), config.Hyperparams(**hp_kw)
    jd = jax_train.build_train_data(coo, w, ju, ji, jhp, B)
    td = train.build_train_data(coo, w, tu, ti, thp, B, "cpu")
    return coo, jd, td, jhp, thp


CASES = [
    ("identity", "adagrad", 0.0),
    ("identity", "adadelta", 1e-3),
    ("padded", "adagrad", 1e-3),
    ("chunked", "adadelta", 0.0),
    ("chunked", "adagrad", 1e-3),
]


@pytest.mark.parametrize("loss", ["logistic", "warp", "bpr", "warp-kos"])
@pytest.mark.parametrize("feats, schedule, alpha", CASES)
def test_one_step_matches_jax(loss, feats, schedule, alpha):
    hp_kw = dict(loss=loss, no_components=D, learning_schedule=schedule, item_alpha=alpha,
                 user_alpha=alpha, learning_rate=0.1, max_sampled=10, n=6, k=3, bpr_tries=8)
    coo, jd, td, jhp, thp = staged(loss, feats, hp_kw)
    if feats == "chunked":
        assert isinstance(td.item_feats, ChunkedRows) and td.item_feats.n_chunks == 3
        assert isinstance(td.user_feats, ChunkedRows)
    elif feats == "padded":
        assert isinstance(td.item_feats, PaddedRows)
    arrays = random_state(td.item_feats.n_cols, td.user_feats.n_cols, schedule == "adadelta",
                          alpha != 0.0, seed=4)

    key = jax.random.key(3)
    kperm, kstep = jax.random.split(key)
    n_batches = td.packed.shape[1] // B
    shuffled = np.asarray(jax_train._shuffle_global(jd.packed, kperm, n_batches, B))[0]
    jb = jax_train._unpack_batch(jnp.asarray(shuffled))
    tb = _unpack_batch5(torch.tensor(shuffled))
    lens = jd.positives.lengths[jb.user_ids] if jd.positives is not None else None
    draws = jax_draws(loss, kstep, jhp, lens, coo.nnz)

    jstep = jax.jit(jax_losses.LOSS_STEPS[loss], static_argnames=("hp",))
    want = jstep(JaxState(**{k: jnp.asarray(v) for k, v in arrays.items()}), jb,
                 jd.user_feats, jd.item_feats, jd.positives, jd.train_items, hp=jhp, key=kstep)
    tstate = interop.state_from_numpy(arrays, "cpu")
    got = losses.LOSS_STEPS[loss](tstate, tb, td.user_feats, td.item_feats, td.positives,
                                  td.train_items, thp, draws)
    for name in JaxState._fields:
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        err = np.abs(g - w) - 1e-5 * np.abs(w)
        assert (err <= 1e-5).all(), (name, float(err.max()))
    # The step moved both tables.
    assert not np.array_equal(got.item_table.numpy(), arrays["item_table"])
    assert not np.array_equal(got.user_table.numpy(), arrays["user_table"])
    if alpha:
        assert float(got.item_log_scale) > float(arrays["item_log_scale"])


def test_kos_slots_from_uniforms():
    u = torch.tensor([[0.0, 0.5, 0.999999940395, 0.25], [0.75, 0.1, 0.5, 0.0]])
    lens = torch.tensor([0, 3, 7, 1], dtype=torch.int32)
    got = losses.kos_slots(u, lens)
    assert got.tolist() == [[0, 1, 6, 0], [0, 0, 3, 0]]
    # Every slot is in [0, max(len, 1)) over a dense sweep of uniforms.
    sweep = torch.rand((1000, 4), generator=torch.Generator().manual_seed(0))
    sweep[-1] = 1.0 - 2.0 ** -24
    s = losses.kos_slots(sweep, lens)
    assert bool((s >= 0).all() and (s < torch.clamp(lens, min=1)[None, :]).all())


def test_first_true_matches_jnp_argmax_on_bool():
    rng = np.random.RandomState(0)
    cand = rng.rand(10, 50) < 0.15
    cand[:, 3] = False  # a row of no violator: index 0, as jnp.argmax gives
    got = losses._first_true(torch.tensor(cand), 0).numpy()
    assert np.array_equal(got, np.asarray(jnp.argmax(jnp.asarray(cand), axis=0)))


def test_masked_touches_point_at_their_entitys_first_feature():
    """Padding slots and masked examples touch the entity's first feature,
    not row 0 (see ``losses._off_row_zero``); unmasked touches keep their
    rows."""
    csr = features("chunked", NI, 2)
    feats = pad_csr(csr, device="cpu", pad_multiple=8, width_cap=8, chunk_width=128)
    rows = torch.arange(NI)
    mask = torch.arange(NI) % 3 != 0
    g = torch.ones(NI, table_width(D))
    (idx, _, _, tmask), (_, _, _, first) = losses._flatten_touches(feats, rows, g, mask)
    idx, tmask = idx.view(NI, -1), tmask.view(NI, -1)
    base = feats.base.idx
    assert torch.equal(idx[tmask], base[tmask])
    assert torch.equal(idx[~tmask], base[:, :1].expand_as(base)[~tmask])
    assert torch.equal(first, base[:, 0]) and int((first == 0).sum()) == 1  # row 0's own
    assert bool(((idx != 0) | (rows[:, None] == 0)).all())
