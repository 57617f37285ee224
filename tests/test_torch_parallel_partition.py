"""Row and component table partitions of the port's mesh on the CPU.

The counterparts of ``tests/test_sharding.py``'s partitioned cases and of
``lightfm_tpu/parallel/mesh.py``'s layouts: where each rank's part of a
table lies, generic epochs on sharded tables against the JAX package's
epochs on the same partition given the same draws, ``LightFM`` trained,
served and checkpointed over a mesh whose tables are split.

Ranks run as gloo processes (``tests/_torch_ranks.py``; this file is their
script), one torch thread a rank: one launch of 2 ranks (a (1, 2) mesh,
and a (2, 1) mesh for the replicated reference of the (2, 2) epochs) and
one of 4 (a (2, 2) mesh).  The JAX side runs in the test process on the 8
virtual CPU devices of ``tests/conftest.py``; one-rank meshes need no
process group and run there too.

Tolerances: a sharded epoch against the JAX package's epoch on the same
partition, ``|got - want| <= 2e-6 + 2e-5 |want|`` (the bound of
``tests/test_fast_warp_mesh.py:81``; f32 summation order); against the
port's replicated epoch with the same draws bitwise wherever
``item_alpha = user_alpha = 0`` (the lookups gather exact rows and each
row's touches apply in the single-device order; with L2 on, the lazy-L2
statistics sum in another order); across ranks bitwise, always.
"""

import os
import pickle
import sys
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_ranks import launch, worker

if __name__ != "__main__":  # the test process; the ranks import the port alone
    import jax
    import jax.numpy as jnp

    import lightfm_tpu
    import lightfm_tpu.checkpoint as jax_checkpoint
    import lightfm_tpu.parallel as jax_parallel
    from lightfm_tpu import config as jax_config
    from lightfm_tpu import train as jax_train
    from lightfm_tpu.state import ModelState as JaxState

import lightfm_tpu_torch
from lightfm_tpu_torch import config, interop, train
from lightfm_tpu_torch.evaluation import auc_score
from lightfm_tpu_torch.parallel import make_mesh, shard_state
from lightfm_tpu_torch.parallel import mesh as pmesh
from lightfm_tpu_torch.sparse import identity_rows, pad_csr
from lightfm_tpu_torch.state import ModelState, init_state, table_width

SCRIPT = os.path.abspath(__file__)
RTOL, ATOL = 2e-5, 2e-6
NOT_DIVISIBLE = "is not divisible by the model axis"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tm(**kw):
    return lightfm_tpu_torch.LightFM(**{**dict(random_state=10, device="cpu"), **kw})


def _small_data(n_users=300, n_items=256, seed=3):
    """``tests/test_sharding.py``'s data: ratings >= 4 positive, the rest negative."""
    from lightfm_tpu_torch.datasets import generate_synthetic

    m = generate_synthetic(n_users=n_users, n_items=n_items, seed=seed)["train"]
    m = m.astype(np.float32)
    m.data = np.where(m.data >= 4, 1.0, -1.0).astype(np.float32)
    return m


def _positives(m):
    m = m.tocsr().copy()
    m.data[m.data < 0] = 0.0
    m.eliminate_zeros()
    return m


def _assert_close(got, want, what):
    err = np.abs(got - want) - RTOL * np.abs(want)
    assert (err <= ATOL).all(), (what, float(err.max()))


# ---------------------------------------------------------------------------
# Generic epochs on split tables
# ---------------------------------------------------------------------------

# (partition, n_data, n_model, shard_examples)
LAYOUTS = [("rows", 1, 2, False), ("components", 1, 2, False), ("rows", 2, 2, True)]
# (name, loss, extra hyperparameters, features, user count): "features" gives
# the items chunked feature rows (a padded tier plus overflow chunks) and the
# users padded ones; 201 users make the user table indivisible by 2 rows.
EPOCH_CASES = [
    ("warp", "warp", {}, False, 200),
    ("bpr", "bpr", {}, False, 200),
    ("logistic", "logistic", {}, False, 200),
    ("kos", "warp-kos", {}, False, 200),
    ("adadelta-l2", "warp", dict(learning_schedule="adadelta", item_alpha=1e-3,
                                 user_alpha=1e-3), False, 200),
    ("features", "warp", {}, True, 200),
    ("l2-fallback", "bpr", dict(item_alpha=1e-3, user_alpha=1e-3), False, 201),
]
N_ITEMS, B, D = 300, 512, 8


def _layout_id(layout):
    return f"{layout[0]}-{layout[1]}x{layout[2]}"


def _epoch_hp(case):
    _, loss, extra, _, _ = case
    return dict(loss=loss, no_components=D, max_sampled=10, bpr_tries=8, n=5, k=2,
                learning_rate=0.1, **extra)


def _epoch_coo(case):
    _, loss, _, _, n_users = case
    rng = np.random.RandomState(4)
    rows = np.repeat(np.arange(n_users), 12)
    cols = rng.randint(0, N_ITEMS, rows.size)
    vals = np.where(rng.rand(rows.size) < 0.3, -1.0, 1.0) if loss == "logistic" else 1.0
    return sp.coo_matrix((np.broadcast_to(vals, rows.shape).astype(np.float32), (rows, cols)),
                         shape=(n_users, N_ITEMS))


def _feature_csr(n, seed, heavy):
    """Identity plus 4 tags a row (weights 0.5 or 1) over 400 tags; with
    ``heavy`` three rows carry 300 tags, past the padded tier's width cap."""
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n), 4)
    cols = rng.randint(0, 400, rows.size)
    if heavy:
        rows = np.concatenate([rows, np.repeat([2, 7, 11], 300)])
        cols = np.concatenate([cols] + [rng.choice(400, 300, replace=False) for _ in range(3)])
    tags = sp.coo_matrix((rng.choice([0.5, 1.0], rows.size), (rows, cols)), shape=(n, 400))
    return sp.hstack([sp.identity(n), tags], format="csr", dtype=np.float32)


def _epoch_feats(case, jax_side):
    """Both sides' feature structures of a case, for one package."""
    _, _, _, feats, n_users = case
    pad = lightfm_tpu.sparse.pad_csr if jax_side else (
        lambda csr, **kw: pad_csr(csr, device="cpu", **kw))
    ident = lightfm_tpu.sparse.identity_rows if jax_side else identity_rows
    if not feats:
        return ident(n_users), ident(N_ITEMS)
    kw = dict(pad_multiple=8, width_cap=8, chunk_width=128)
    return pad(_feature_csr(n_users, 1, False), **kw), pad(_feature_csr(N_ITEMS, 2, True), **kw)


def _random_arrays(n_items, n_users, adadelta, seed):
    rng = np.random.RandomState(seed)
    W = table_width(D)
    out = {}
    for side, n in (("item", n_items), ("user", n_users)):
        t = np.zeros((n, W), np.float32)
        t[:, :D] = rng.randn(n, D) / np.sqrt(D)
        t[:, -1] = 0.1 * rng.randn(n)
        out[f"{side}_table"] = t
        out[f"{side}_acc"] = (0.2 * rng.rand(n, W) if adadelta else 1 + rng.rand(n, W)
                              ).astype(np.float32)
        out[f"{side}_mom"] = (0.01 * rng.rand(n, W) if adadelta else np.zeros((n, W))
                              ).astype(np.float32)
    out["item_log_scale"] = np.float32(0.3)
    out["user_log_scale"] = np.float32(0.2)
    return out


def _jax_draws(key, jd, hp, n_pad):
    """The draws of the JAX package's generic epoch (``train.py:297-299``;
    ``losses.py``) as :class:`train.GenericDraws` arrays (global shuffle)."""
    n_batches = n_pad // B
    kperm, kbatch = jax.random.split(key)
    keys = jax.random.split(kbatch, n_batches)
    out = {"perm": np.asarray(jax.random.bits(kperm, (n_pad,), jnp.uint32)).astype(np.int64)}
    shuffled = np.asarray(jax_train._shuffle_global(jd.packed, kperm, n_batches, B))
    neg, tries, kos_u = [], [], []
    for b, bkey in enumerate(keys):
        if hp.loss == "warp":
            neg.append(jax.random.randint(bkey, (hp.max_sampled, B), 0, N_ITEMS, jnp.int32))
        elif hp.loss == "bpr":
            tries.append(jax.random.randint(bkey, (B, hp.bpr_tries), 0,
                                            jd.train_items.shape[0], jnp.int32))
        elif hp.loss == "warp-kos":
            kpos, kneg = jax.random.split(bkey)
            bound = np.maximum(np.asarray(jd.positives.lengths)[shuffled[b, 0]], 1)
            slots = np.asarray(jax.random.randint(kpos, (hp.n, B), 0, jnp.asarray(bound)[None, :],
                                                  jnp.int32))
            kos_u.append(((slots + 0.5) / bound[None, :]).astype(np.float32))
            neg.append(jax.random.randint(kneg, (hp.max_sampled, B), 0, N_ITEMS, jnp.int32))
    for name, xs in (("neg", neg), ("tries", tries), ("kos_u", kos_u)):
        if xs:
            out[name] = np.stack([np.asarray(x) for x in xs])
    return out


def _port_data(case, hp):
    coo = _epoch_coo(case)
    uf, itf = _epoch_feats(case, jax_side=False)
    return train.build_train_data(coo, np.ones_like(coo.data), uf, itf, hp, B, "cpu")


def _draws_of(inputs, tag):
    return train.GenericDraws(*(torch.from_numpy(inputs[f"{tag}_{n}"]) if f"{tag}_{n}" in inputs
                                else None for n in train.GenericDraws._fields))


def _sharded_epochs(inputs, mesh, layouts, out, prefix="") -> None:
    """Each case of ``layouts`` (on ``mesh``): one generic epoch from the
    case's state with the case's draws, the state placed by the layout's
    partition (``"replicated"`` with ``prefix="rep_"``), assembled."""
    for layout in layouts:
        partition, _, _, shard_examples = layout
        if prefix:
            partition = "replicated"
        for case in EPOCH_CASES:
            tag = f"{_layout_id(layout)}_{case[0]}"
            hp = config.Hyperparams(**_epoch_hp(case))
            td = pmesh.shard_train_data(_port_data(case, hp), mesh, shard_examples)
            whole = interop.state_from_numpy({n: inputs[f"{tag}_{n}"] for n in ModelState._fields},
                                             "cpu")
            placement = pmesh.plan_placement(mesh, partition, whole.item_table.shape,
                                             whole.user_table.shape)
            state = pmesh.place_state(whole, placement)
            out[f"{prefix}{tag}_local_item"] = np.array(state.item_table.shape)
            out[f"{prefix}{tag}_local_user"] = np.array(state.user_table.shape)
            got = train.generic_epoch(state, td, _draws_of(inputs, tag), hp, B, mesh, "global",
                                      placement)
            got = pmesh.assemble_state(got, placement)
            out.update({f"{prefix}{tag}_{n}": x.numpy() for n, x in zip(ModelState._fields, got)})


@pytest.fixture(scope="module")
def epoch_inputs():
    """Each (layout, case): its state and draws, the JAX package's epoch on
    the layout's mesh and partition, and for one data coordinate the port's
    one-device epoch."""
    inputs, want, single = {}, {}, {}
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=f".*{NOT_DIVISIBLE}")
        for li, layout in enumerate(LAYOUTS):
            partition, n_data, n_model, shard_examples = layout
            jm = jax_parallel.make_mesh(n_data=n_data, n_model=n_model,
                                        devices=jax.devices()[:n_data * n_model])
            for ci, case in enumerate(EPOCH_CASES):
                tag = f"{_layout_id(layout)}_{case[0]}"
                kw = _epoch_hp(case)
                jhp = jax_config.Hyperparams(**kw)
                coo = _epoch_coo(case)
                ju, ji = _epoch_feats(case, jax_side=True)
                jd = jax_train.build_train_data(coo, np.ones_like(coo.data), ju, ji, jhp, B)
                arrays = _random_arrays(ji.n_cols, ju.n_cols, "learning_schedule" in case[2],
                                        seed=11 * li + ci)
                key = jax.random.key(5 + ci)
                draws = _jax_draws(key, jd, jhp, jd.packed.shape[1])
                jstate = jax_parallel.shard_state(
                    JaxState(**{k: jnp.asarray(v) for k, v in arrays.items()}), jm, partition)
                jdata = jax_parallel.shard_train_data(jd, jm, shard_examples)
                with jm:
                    got = jax_train.run_epoch(jstate, jdata, key, jhp, B, mesh=jm, fast=False)
                want[tag] = {n: np.asarray(x) for n, x in zip(JaxState._fields, got)}
                if n_data == 1:
                    thp = config.Hyperparams(**kw)
                    one = train.generic_epoch(interop.state_from_numpy(arrays, "cpu"),
                                              _port_data(case, thp),
                                              _draws_of({f"{tag}_{n}": v for n, v in draws.items()},
                                                        tag), thp, B)
                    single[tag] = {n: x.numpy() for n, x in zip(ModelState._fields, one)}
                inputs.update({f"{tag}_{n}": np.asarray(v) for n, v in arrays.items()})
                inputs.update({f"{tag}_{n}": v for n, v in draws.items()})
    return inputs, want, single


# ---------------------------------------------------------------------------
# The ranks' scenarios
# ---------------------------------------------------------------------------


def _count_saves():
    """The checkpoint files this rank writes (every rank calls
    ``save_model`` on a split model; rank 0 alone writes)."""
    from lightfm_tpu_torch import checkpoint

    calls = []
    real = checkpoint._write

    def write(path, arrays):
        calls.append(path)
        real(path, arrays)

    checkpoint._write = write
    return calls


SERVE_USERS = np.arange(0, 300, 3)


def _serving(m, train_m, out, tag):
    """Everything a user reads off a fitted model, as arrays."""
    pos = _positives(train_m)
    out[f"{tag}_predict"] = m.predict(np.repeat(np.arange(30), 4), np.tile(np.arange(4), 30) * 60)
    ranks = m.predict_rank(pos)
    out[f"{tag}_ranks"] = ranks.data
    out[f"{tag}_auc"] = auc_score(m, pos)
    for kind, kw in (("plain", {}), ("excl", dict(train_interactions=train_m))):
        s, i = m.recommend(SERVE_USERS, k=10, **kw)
        out[f"{tag}_rec_{kind}_s"], out[f"{tag}_rec_{kind}_i"] = s, i
    # Copies: the accessors hand out views that later edits write through.
    out[f"{tag}_item_rep_b"], out[f"{tag}_item_rep_e"] = map(np.array,
                                                             m.get_item_representations())
    out[f"{tag}_user_rep_b"], out[f"{tag}_user_rep_e"] = map(np.array,
                                                             m.get_user_representations())
    out[f"{tag}_item_embeddings"] = np.array(m.item_embeddings)
    out[f"{tag}_user_bias_gradients"] = np.array(m.user_bias_gradients)
    out[f"{tag}_params"] = np.str_(repr(sorted((k, v) for k, v in m.get_params().items()
                                               if k not in ("mesh", "random_state"))))


def _two_ranks(inputs, rank, tmp):
    """A (1, 2) mesh: rows and components epochs and fits, serving and
    state on the split model; a (2, 1) mesh: the replicated reference
    epochs of the (2, 2) layout."""
    out = {}
    mesh = make_mesh(n_data=1, n_model=2, device="cpu")
    _sharded_epochs(inputs, mesh, [lay for lay in LAYOUTS if lay[1] == 1], out)
    train_m = _small_data()
    for partition in ("rows", "components"):
        m = _tm(loss="warp", mesh=mesh, table_partition=partition).fit(train_m, epochs=3)
        out[f"{partition}_local"] = np.array([m._state.item_table.shape, m._state.user_table.shape])
        out[f"{partition}_layout"] = np.str_(f"{m._placement.item.layout}/"
                                             f"{m._placement.user.layout}")
        whole = m._whole_state()
        out.update({f"{partition}_fit_{n}": x.numpy() for n, x in zip(ModelState._fields, whole)})
        # Serving assembles the two tables alone; the optimizer fields stay parts.
        serving = m._serving_state()
        out[f"{partition}_serving_shapes"] = np.array(
            [serving.item_table.shape, serving.user_table.shape, serving.item_acc.shape])
        _serving(m, train_m, out, partition)
        # A pickle carries the whole state and no mesh.
        back = pickle.loads(pickle.dumps(m))
        out[f"{partition}_pickle_equal"] = np.bool_(
            back.mesh is None and all(torch.equal(a, b) for a, b in zip(back._state, whole)))
        # Writes through the state attributes land in each rank's part.
        m.item_biases = np.arange(256, dtype=np.float32)
        m.user_embeddings[5, :] = 7.0  # an in-place edit of a handed-out view
        out[f"{partition}_edited_predict"] = m.predict(np.arange(10), np.arange(10))
        out[f"{partition}_edited_local"] = m._state.item_table[:, -1].numpy().copy()
        edited = m._whole_state()
        out[f"{partition}_edited_item"] = edited.item_table.numpy()
        out[f"{partition}_edited_user"] = edited.user_table.numpy()
        # fit_partial goes on from the split state, which stays split; the
        # rows model goes on split by components (assembled, then re-cut).
        m.table_partition = "components"
        m.fit_partial(train_m, epochs=1)
        out[f"{partition}_partial_local"] = np.array(m._state.item_table.shape)
        out[f"{partition}_partial_item"] = m._whole_state().item_table.numpy()
    # An axis of one rank needs no collective: over it a gather is the input.
    calls, x = mesh.stats["calls"], torch.arange(6.0).reshape(3, 2)
    same = [pmesh.all_gather_rows(mesh, x)[0], pmesh.sum_over_data(mesh, x)[0]]
    out["one_rank_data_axis"] = np.array([mesh.stats["calls"] - calls,
                                          all(y is x for y in same)])
    rep = make_mesh(n_data=2, n_model=1, device="cpu")
    _sharded_epochs(inputs, rep, [lay for lay in LAYOUTS if lay[1] == 2], out, prefix="rep_")
    out["collectives"] = np.array([mesh.stats["calls"], mesh.stats["bytes"]], np.int64)
    return out


def _four_ranks(inputs, rank, tmp):
    """A (2, 2) mesh: the rows epochs with example-sharded input, and the
    counterparts of ``tests/test_sharding.py``'s fits; checkpoints."""
    from lightfm_tpu_torch.checkpoint import load_model

    out = {}
    mesh = make_mesh(n_data=2, n_model=2, device="cpu")
    _sharded_epochs(inputs, mesh, [lay for lay in LAYOUTS if lay[1] == 2], out)
    train_m = _small_data()
    pos = _positives(train_m)

    for partition in ("rows", "components"):  # test_sharded_fit_trains
        m = _tm(loss="warp", no_components=15 if partition == "components" else 10, mesh=mesh,
                table_partition=partition).fit(train_m, epochs=5)
        out[f"trains_{partition}_auc"] = np.float64(auc_score(m, pos).mean())
        out[f"trains_{partition}_item"] = m._whole_state().item_table.numpy()
    m = _tm(loss="warp", mesh=mesh, table_partition="rows", shard_examples=True)
    m.fit(train_m, epochs=3)  # test_combined_example_and_table_sharding
    out["combined_auc"] = np.float64(auc_score(m, pos).mean())
    out["combined_item"] = m._whole_state().item_table.numpy()
    m = _tm(loss="warp", mesh=mesh, batch_size=512, table_partition="rows", shard_examples=True,
            example_shuffle="local").fit(train_m, epochs=5)  # test_local_shuffle_trains
    out["local_auc"] = np.float64(auc_score(m, pos).mean())

    # test_row_sharding_with_indivisible_tables
    wide = _small_data(n_users=943, n_items=256, seed=6)
    m = _tm(loss="warp", mesh=mesh, table_partition="rows")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        m.fit(wide, epochs=3)
    out["indivisible_warnings"] = np.array([str(w.message) for w in caught
                                            if NOT_DIVISIBLE in str(w.message)])
    out["indivisible_local"] = np.array([m._state.item_table.shape, m._state.user_table.shape])
    out["indivisible_auc"] = np.float64(auc_score(m, _positives(wide)).mean())

    # test_auto_table_partition_resolution
    os.environ["LIGHTFM_TPU_REPLICATED_TABLE_BUDGET"] = "1024"
    m = _tm(loss="warp", mesh=mesh, table_partition="auto").fit(train_m, epochs=1)
    out["auto"] = np.str_(f"{m._resolve_table_partition()}/{m._placement.item.layout}")
    del os.environ["LIGHTFM_TPU_REPLICATED_TABLE_BUDGET"]
    out["auto_local"] = np.array(m._state.item_table.shape)
    out["auto_finite"] = np.bool_(np.isfinite(m.item_embeddings).all())

    # Mid-fit checkpoints: written by rank 0 alone, the whole state, and a
    # resumed run is bit-exact.
    saves = _count_saves()
    full = _tm(loss="warp", mesh=mesh, table_partition="rows", random_state=5).fit(train_m,
                                                                                epochs=3)
    path = os.path.join(tmp, "cut.npz")
    cut = _tm(loss="warp", mesh=mesh, table_partition="rows", random_state=5)
    cut.fit(train_m, epochs=2, checkpoint_every_n_epochs=1, checkpoint_path=path)
    out["saves"] = np.int64(len(saves))
    out.update({f"cut_{n}": x.numpy() for n, x in zip(ModelState._fields, cut._whole_state())})
    resumed = load_model(path, device="cpu")
    resumed.mesh = mesh
    resumed.fit_partial(train_m, epochs=1, checkpoint_every_n_epochs=1,
                        checkpoint_path=os.path.join(tmp, "resumed.npz"))
    out["saves_after_resume"] = np.int64(len(saves))
    out["resumed_layout"] = np.str_(resumed._placement.item.layout)
    out["resumed_equal"] = np.bool_(all(torch.equal(a, b) for a, b in
                                        zip(full._whole_state(), resumed._whole_state())))
    out["collectives"] = np.array([mesh.stats["calls"], mesh.stats["bytes"]], np.int64)
    return out


@pytest.fixture(scope="module")
def ranks(epoch_inputs, tmp_path_factory):
    inputs = epoch_inputs[0]
    two = launch(SCRIPT, "two", tmp_path_factory.mktemp("two"), inputs, world=2, timeout=120)
    tmp4 = tmp_path_factory.mktemp("four")
    four = launch(SCRIPT, "four", tmp4, inputs, world=4, timeout=120)
    return two, four, tmp4


# ---------------------------------------------------------------------------
# (i) Generic epochs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", EPOCH_CASES, ids=[c[0] for c in EPOCH_CASES])
@pytest.mark.parametrize("layout", LAYOUTS, ids=[_layout_id(lay) for lay in LAYOUTS])
def test_sharded_generic_epoch_matches_jax_and_replicated(epoch_inputs, ranks, layout, case):
    inputs, want, single = epoch_inputs
    two, four, _ = ranks
    tag = f"{_layout_id(layout)}_{case[0]}"
    outs = two if layout[1] == 1 else four
    lazy = "item_alpha" in case[2]
    for name in ModelState._fields:
        got = outs[0][f"{tag}_{name}"]
        for r in outs[1:]:
            assert np.array_equal(got, r[f"{tag}_{name}"]), ("ranks differ", name)
        _assert_close(got, want[tag][name], ("jax", name))
        replicated = single[tag][name] if layout[1] == 1 else two[0][f"rep_{tag}_{name}"]
        if lazy:
            _assert_close(got, replicated, ("replicated", name))
        else:
            assert np.array_equal(got, replicated), ("replicated, bitwise", name)
    assert not np.array_equal(outs[0][f"{tag}_item_table"], inputs[f"{tag}_item_table"])


@pytest.mark.parametrize("layout", LAYOUTS, ids=[_layout_id(lay) for lay in LAYOUTS])
def test_each_rank_holds_its_part_in_the_epochs(ranks, layout):
    partition, _, n_model, _ = layout
    outs = ranks[0] if layout[1] == 1 else ranks[1]
    W = table_width(D)
    for case in EPOCH_CASES:
        tag = f"{_layout_id(layout)}_{case[0]}"
        n_user_rows = outs[0][f"{tag}_user_table"].shape[0]
        n_item_rows = outs[0][f"{tag}_item_table"].shape[0]
        for r in outs:
            item, user = tuple(r[f"{tag}_local_item"]), tuple(r[f"{tag}_local_user"])
            if partition == "components":
                assert item == (n_item_rows, W // n_model) and user == (n_user_rows, W // n_model)
            else:
                assert item == (n_item_rows // n_model, W)
                # 201 users do not divide by 2: that table stays whole.
                assert user == ((n_user_rows, W) if n_user_rows % n_model
                                else (n_user_rows // n_model, W))


# ---------------------------------------------------------------------------
# (ii) Layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("partition", ["rows", "components"])
def test_state_sharding_layouts(partition):
    """``tests/test_sharding.py::test_state_sharding_layouts``: every rank
    of a (4, 2) mesh holds its half of each table (rows: ``256 // 2`` of
    the item table), and the parts tile the whole."""
    state = init_state(8, 256, 128, np.random.RandomState(0), adagrad=True)
    parts = []
    for rank in range(8):
        mesh = pmesh.Mesh(4, 2, rank, torch.device("cpu"))  # shapes only: no group
        parts.append(shard_state(state, mesh, partition))
    for rank, part in enumerate(parts):
        m = rank % 2
        if partition == "rows":
            assert part.item_table.shape == (256 // 2, 16) and part.user_table.shape == (64, 16)
            assert torch.equal(part.item_acc, state.item_acc[m * 128:(m + 1) * 128])
        else:
            assert part.item_table.shape == (256, 8) and part.user_mom.shape == (128, 8)
            assert torch.equal(part.user_table, state.user_table[:, m * 8:(m + 1) * 8])
        assert part.item_log_scale.shape == ()
    whole = torch.cat([p.item_table for p in parts[:2]], dim=0 if partition == "rows" else 1)
    assert torch.equal(whole, state.item_table)


def test_indivisible_table_warns_and_stays_whole():
    """The JAX text, once per row count; the divisible side stays split."""
    state = init_state(8, 256, 301, np.random.RandomState(0), adagrad=True)
    mesh = pmesh.Mesh(1, 2, 1, torch.device("cpu"))
    with pytest.warns(UserWarning, match=r"table with 301 rows is not divisible by the model "
                      r"axis \(2\); replicating it instead of row-sharding") as caught:
        part = shard_state(state, mesh, "rows")
    assert len([w for w in caught if NOT_DIVISIBLE in str(w.message)]) == 1
    assert part.user_table.shape == (301, 16) and torch.equal(part.user_table, state.user_table)
    assert torch.equal(part.item_table, state.item_table[128:])
    p = pmesh.plan_placement(mesh, "rows", (256, 16), (301, 16))
    assert (p.item.layout, p.item.start, p.item.stop) == ("rows", 128, 256)
    assert p.user.layout == "replicated" and p.sharded


def test_components_with_an_indivisible_width_raise():
    state = init_state(8, 256, 128, np.random.RandomState(0), adagrad=True)  # W = 16
    with pytest.raises(ValueError, match=r"width \(= 16.*divisible by the model-axis size 3"):
        shard_state(state, pmesh.Mesh(1, 3, 0, torch.device("cpu")), "components")
    with pytest.raises(ValueError, match="table_partition must be one of"):
        shard_state(state, make_mesh(device="cpu"), "columns")


@pytest.mark.parametrize("partition", ["rows", "components"])
def test_init_keeps_each_part_of_the_whole_init(partition):
    """``init_state(..., part=...)`` cuts each table as it is drawn: every
    rank's part is that rank's cut of the whole initial state, and its
    accumulators are drawn only at part size."""
    whole = init_state(8, 256, 128, np.random.RandomState(0), adagrad=True)
    for rank in range(2):
        mesh = pmesh.Mesh(1, 2, rank, torch.device("cpu"))  # shapes only: no group
        placement = pmesh.plan_placement(mesh, partition, (256, 16), (128, 16))
        part = init_state(8, 256, 128, np.random.RandomState(0), adagrad=True,
                          share_seed=lambda seed: seed, part=placement.part)
        for name, x in zip(ModelState._fields, whole):
            assert torch.equal(getattr(part, name), placement.part(name, x)), name


def test_placing_again_is_harmless():
    """``fit_partial`` places the state again: a state placed as asked
    comes back as it is (re-placing a split state: the 2-rank fits)."""
    state = init_state(8, 256, 128, np.random.RandomState(0), adagrad=True)
    mesh = pmesh.Mesh(1, 2, 1, torch.device("cpu"))
    rows = pmesh.plan_placement(mesh, "rows", (256, 16), (128, 16))
    part = shard_state(state, mesh, "rows")
    assert pmesh.place_state(part, rows, rows) is part
    whole = pmesh.place_state(state, pmesh.plan_placement(mesh, "replicated", (256, 16),
                                                          (128, 16)))
    assert all(torch.equal(a, b) for a, b in zip(whole, state))


# ---------------------------------------------------------------------------
# (iii) LightFM over the mesh
# ---------------------------------------------------------------------------


def test_two_ranks_agree_bit_for_bit(ranks):
    for outs in ranks[:2]:
        assert all(r.keys() == outs[0].keys() for r in outs)
        per_rank = {"saves", "saves_after_resume", "collectives", "rows_edited_local",
                    "components_edited_local"}
        for k in outs[0].keys() - per_rank:
            for r in outs[1:]:
                assert np.array_equal(outs[0][k], r[k]), k
        assert all(r["collectives"][0] > 0 for r in outs)


def test_a_data_axis_of_one_rank_sends_nothing(ranks):
    for r in ranks[0]:
        assert r["one_rank_data_axis"].tolist() == [0, 1]


@pytest.mark.parametrize("partition", ["rows", "components"])
def test_one_model_rank_pair_fit_is_bitwise_the_plain_fit(ranks, partition):
    """A (1, 2) mesh fit: each rank holds half of each table, and the whole
    state is bitwise the fit without a mesh (alpha = 0)."""
    r0 = ranks[0][0]
    plain = _tm(loss="warp").fit(_small_data(), epochs=3)
    W = table_width(10)
    want = [[128, W], [150, W]] if partition == "rows" else [[256, W // 2], [300, W // 2]]
    assert r0[f"{partition}_local"].tolist() == want
    assert r0[f"{partition}_serving_shapes"].tolist() == [[256, W], [300, W], want[0]]
    assert str(r0[f"{partition}_layout"]) == f"{partition}/{partition}"
    for name, x in zip(ModelState._fields, plain._state):
        assert np.array_equal(r0[f"{partition}_fit_{name}"], x.numpy()), name


@pytest.mark.parametrize("partition", ["rows", "components"])
def test_sharded_fit_trains(ranks, partition):
    """``tests/test_sharding.py::test_sharded_fit_trains`` on a (2, 2) mesh."""
    assert ranks[1][0][f"trains_{partition}_auc"] > 0.8


def test_combined_example_and_table_sharding(ranks):
    r0 = ranks[1][0]
    assert r0["combined_auc"] > 0.8
    assert np.isfinite(r0["combined_item"]).all()


def test_local_shuffle_trains(ranks):
    assert ranks[1][0]["local_auc"] > 0.8


def test_row_sharding_with_indivisible_tables(ranks):
    r0 = ranks[1][0]
    assert len(r0["indivisible_warnings"]) == 1
    assert "table with 943 rows" in str(r0["indivisible_warnings"][0])
    assert r0["indivisible_local"].tolist() == [[128, 16], [943, 16]]
    assert r0["indivisible_auc"] > 0.75


def test_auto_table_partition_resolution(ranks, monkeypatch):
    """``"auto"`` beyond the budget resolves to rows, which now trains."""
    r0 = ranks[1][0]
    assert str(r0["auto"]) == "rows/rows" and r0["auto_local"].tolist() == [128, 16]
    assert r0["auto_finite"]
    monkeypatch.setenv("LIGHTFM_TPU_REPLICATED_TABLE_BUDGET", "1024")
    m = _tm(loss="warp", mesh=make_mesh(device="cpu"), table_partition="auto")
    with pytest.warns(UserWarning, match="model' axis has size 1"):
        m.fit(_small_data(), epochs=1)
    assert m._resolve_table_partition() == "rows" and m._placement.item.layout == "rows"
    # The budget counts the whole state, however it is placed now.
    whole = sum(x.numel() * x.element_size() for x in m._whole_state())
    monkeypatch.setenv("LIGHTFM_TPU_REPLICATED_TABLE_BUDGET", str(whole))
    assert m._resolve_table_partition() == "replicated"


# ---------------------------------------------------------------------------
# (iv) Serving and state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("partition", ["rows", "components"])
def test_serving_a_split_model_equals_the_replicated_model(ranks, partition):
    """``predict``, ``predict_rank``, ``auc_score``, ``recommend`` (through
    ``top_k_sharded``), the representations, the state attributes and
    ``get_params`` of the split model are those of the model without a
    mesh whose state is the same (the fits are bitwise equal)."""
    r0 = ranks[0][0]
    train_m = _small_data()
    plain = _tm(loss="warp", table_partition=partition).fit(train_m, epochs=3)
    want = {}
    _serving(plain, train_m, want, "x")
    for key, value in want.items():
        got = r0[f"{partition}{key[1:]}"]
        if key.endswith("_rec_plain_s") or key.endswith("_rec_excl_s"):
            np.testing.assert_allclose(got, value, rtol=0, atol=1e-6)
        else:
            assert np.array_equal(got, value), key


@pytest.mark.parametrize("partition", ["rows", "components"])
def test_state_writes_and_pickles_of_a_split_model(ranks, partition):
    r0, r1 = ranks[0]
    assert r0[f"{partition}_pickle_equal"] and r1[f"{partition}_pickle_equal"]
    plain = _tm(loss="warp").fit(_small_data(), epochs=3)
    plain.item_biases = np.arange(256, dtype=np.float32)
    plain.user_embeddings[5, :] = 7.0
    assert np.array_equal(r0[f"{partition}_edited_predict"],
                          plain.predict(np.arange(10), np.arange(10)))
    assert np.array_equal(r0[f"{partition}_edited_item"], plain._state.item_table.numpy())
    assert np.array_equal(r0[f"{partition}_edited_user"], plain._state.user_table.numpy())
    if partition == "rows":  # each rank's part holds its rows' new biases
        assert np.array_equal(r0["rows_edited_local"], np.arange(128, dtype=np.float32))
        assert np.array_equal(r1["rows_edited_local"], np.arange(128, 256, dtype=np.float32))
    plain.fit_partial(_small_data(), epochs=1)
    assert np.array_equal(r0[f"{partition}_partial_item"], plain._state.item_table.numpy())
    assert r0[f"{partition}_partial_local"].tolist() == [256, 8]


def test_split_checkpoint_written_once_loads_in_both_packages_and_resumes(ranks):
    two, four, tmp = ranks
    assert [r["saves"] for r in four] == [2, 0, 0, 0]
    assert [r["saves_after_resume"] for r in four] == [3, 0, 0, 0]
    assert all(r["resumed_equal"] for r in four)
    assert str(four[0]["resumed_layout"]) == "rows"
    path = os.path.join(str(tmp), "cut.npz")
    port = lightfm_tpu_torch.load_model(path, device="cpu")
    jm = jax_checkpoint.load_model(path)
    for name in ModelState._fields:
        want = four[0][f"cut_{name}"]
        assert np.array_equal(getattr(port._state, name).numpy(), want), name
        assert np.array_equal(np.asarray(getattr(jm._state, name)), want), name
    assert port.table_partition == jm.table_partition == "rows"


def test_a_local_shuffle_checkpoint_is_refused_as_in_jax(tmp_path):
    """A checkpoint of a locally shuffled fit holds the whole state, and
    ``load_model`` refuses it in both packages alike: their constructors
    take ``example_shuffle="local"`` only with a mesh."""
    train_m, mesh = _small_data(), make_mesh(device="cpu")
    kw = dict(loss="warp", mesh=mesh, table_partition="rows", shard_examples=True,
              example_shuffle="local", batch_size=512, random_state=5)
    m = _tm(**kw).fit(train_m, epochs=1, checkpoint_every_n_epochs=1,
                      checkpoint_path=str(tmp_path / "local.npz"))
    with np.load(tmp_path / "local.npz") as z:
        for name, x in zip(ModelState._fields, m._whole_state()):
            assert np.array_equal(z[f"state_{name}"], x.numpy()), name
    with pytest.raises(ValueError, match="example_shuffle='local'"):
        lightfm_tpu_torch.load_model(str(tmp_path / "local.npz"), device="cpu")
    with pytest.raises(ValueError, match="example_shuffle='local'"):
        jax_checkpoint.load_model(str(tmp_path / "local.npz"))


# ---------------------------------------------------------------------------
# (v) One-rank meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("partition", ["rows", "components"])
@pytest.mark.parametrize("kw", [
    dict(loss="warp"),
    dict(loss="bpr", learning_schedule="adadelta", item_alpha=1e-3, user_alpha=1e-3),
    dict(loss="warp-kos", n=5, k=2),
    dict(loss="logistic", user_alpha=1e-3),
], ids=["warp", "bpr-adadelta-l2", "kos", "logistic-l2"])
def test_one_rank_mesh_is_bitwise_the_plain_fit(kw, partition):
    """A one-rank mesh holds the whole table as its one part: rows and
    components fit, serve and assemble bitwise as without a mesh."""
    train_m = _small_data()
    plain = _tm(**kw).fit(train_m, epochs=2)
    mesh = make_mesh(device="cpu")
    m = _tm(mesh=mesh, table_partition=partition, **kw).fit(train_m, epochs=2)
    assert m._placement.item.layout == partition and m._placement.sharded
    for a, b in zip(plain._state, m._state):
        assert torch.equal(a, b)
    assert np.array_equal(plain.predict(np.arange(20), np.arange(20)),
                          m.predict(np.arange(20), np.arange(20)))
    assert np.array_equal(plain.recommend([0, 5], k=4)[1], m.recommend([0, 5], k=4)[1])
    assert mesh.stats["calls"] == 0


if __name__ == "__main__":
    sys.exit(worker({"two": _two_ranks, "four": _four_ranks}))
