"""The port's multi-device layer on the CPU: meshes, collectives, the local
shuffle, the generic path and ``LightFM`` over a mesh, ``top_k_sharded``.

Two-rank cases run as gloo ranks: this file runs itself as their script
(``tests/_torch_ranks.py``), one torch thread a rank, each launch running
several scenarios.  The JAX side runs in the test process on 2 of the 8
virtual CPU devices (``tests/conftest.py``).  One-rank meshes need no
process group and run in the test process.

Tolerances: generic epochs of two ranks against the JAX package's
``mesh=`` epochs given the same draws, and mesh fits against one-device
fits, ``|got - want| <= 2e-6 + 2e-5 * |want|``, the JAX mesh test's own
bound (``tests/test_fast_warp_mesh.py:81``; f32 summation order);
shuffled blocks and the two ranks' states bitwise, always.  ``recommend`` through ``top_k_sharded`` returns
``top_k``'s ids, its scores within 1e-6.
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
    import lightfm_tpu.parallel as jax_parallel
    from lightfm_tpu import config as jax_config
    from lightfm_tpu import train as jax_train
    from lightfm_tpu.state import ModelState as JaxState

import lightfm_tpu_torch
from lightfm_tpu_torch import config, interop, retrieval, train
from lightfm_tpu_torch.parallel import mesh as pmesh
from lightfm_tpu_torch.parallel import build_local_train_data, make_mesh, shard_state
from lightfm_tpu_torch.sparse import identity_rows
from lightfm_tpu_torch.state import ModelState, init_state, table_width

SCRIPT = os.path.abspath(__file__)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tm(**kw):
    return lightfm_tpu_torch.LightFM(**{**dict(random_state=10, device="cpu"), **kw})


def _interactions(nu, ni, per_user, seed, signed=False):
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(nu), per_user)
    cols = rng.randint(0, ni, rows.size)
    vals = np.where(rng.rand(rows.size) < 0.3, -1.0, 1.0) if signed else np.ones(rows.size)
    return sp.coo_matrix((vals.astype(np.float32), (rows, cols)), shape=(nu, ni))


def _small_data():
    """``tests/test_sharding.py``'s data: the synthetic twin at 300 x 256,
    ratings >= 4 as positives, the rest as negatives."""
    from lightfm_tpu_torch.datasets import generate_synthetic

    train_m = generate_synthetic(n_users=300, n_items=256, seed=3)["train"].astype(np.float32)
    train_m.data = np.where(train_m.data >= 4, 1.0, -1.0).astype(np.float32)
    return train_m


def _positives(m):
    m = m.tocsr().copy()
    m.data[m.data < 0] = 0.0
    m.eliminate_zeros()
    return m


def _assert_close(got, want, rtol, atol, what):
    err = np.abs(got - want) - rtol * np.abs(want)
    assert (err <= atol).all(), (what, float(err.max()))


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


# ---------------------------------------------------------------------------
# One rank, in the test process
# ---------------------------------------------------------------------------


def test_mesh_of_one_rank_needs_no_process_group():
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.axis_names == ("data", "model")
    assert mesh.coords == {"data": 0, "model": 0} and not mesh.distributed
    assert make_mesh(n_data=1, device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match=r"Mesh shape \(2, 1\) does not match 1 devices"):
        make_mesh(n_data=2)
    x = torch.arange(6.0).reshape(3, 2)
    assert pmesh.all_gather_rows(mesh, x)[0] is x
    assert pmesh.sum_over_data(mesh, x)[0] is x
    assert mesh.stats["calls"] == 0


def test_mesh_device_is_never_chosen_silently(monkeypatch):
    """Without CUDA a mesh runs on the CPU only when asked to, and a model
    whose device is not its mesh's refuses to fit."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(device="cuda")
    elsewhere = pmesh.Mesh(1, 1, 0, torch.device("cuda", 1))
    with pytest.raises(ValueError, match=r"model's device \(cpu\) is not the mesh's \(cuda:1\)"):
        _tm(mesh=elsewhere).fit(_small_data(), epochs=1)


def test_collective_blocks_round_trip_every_dtype():
    """One collective carries mixed dtypes as one uint8 block."""
    ts = [torch.arange(5, dtype=torch.int32), torch.randn(5, 3),
          torch.tensor([True, False, True, True, False]), torch.arange(10.0).reshape(5, 2)]
    block, specs = pmesh._as_bytes(ts, 5)
    assert block.dtype == torch.uint8 and block.shape == (5, 4 + 12 + 1 + 8)
    for a, b in zip(ts, pmesh._from_bytes(block, specs)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("partition", ["rows", "components"])
def test_row_and_component_partitions_train_on_one_rank(partition):
    """``tests/test_sharding.py::test_sharded_fit_trains`` and
    ``::test_state_sharding_layouts`` on a one-rank mesh: fit, shard_state
    and recommend work, the one rank holding the whole table as its part
    (more ranks: ``tests/test_torch_parallel_partition.py``)."""
    m = _tm(loss="warp", mesh=make_mesh(device="cpu"), table_partition=partition)
    m.fit(_small_data(), epochs=1)
    assert m._placement.item.layout == partition and m._staged_fast is False
    assert m._state.item_table.shape == (256, table_width(10))
    state = init_state(8, 256, 128, np.random.RandomState(0), adagrad=True)
    placed = shard_state(state, make_mesh(device="cpu"), partition)
    assert all(torch.equal(a, b) for a, b in zip(placed, state))
    scores, ids = m.recommend([0], k=2)
    assert ids.shape == (1, 2) and np.isfinite(scores).all()


def test_a_mesh_that_is_not_a_mesh_raises_type_error():
    with pytest.raises(TypeError, match="make_mesh"):
        _tm(mesh=object()).fit(_small_data(), epochs=1)


@pytest.mark.parametrize("kw", [
    dict(loss="warp"),
    dict(loss="bpr", learning_schedule="adadelta", item_alpha=1e-3),
    dict(loss="warp", no_components=64, batch_size=4096, fast_path="on"),
])
def test_mesh_of_one_rank_is_bitwise_the_plain_fit(kw):
    """A world of one rank: the mesh fit is the fit without a mesh."""
    coo = _interactions(1500, 8000, 30, seed=3) if kw.get("fast_path") else _small_data()
    plain = _tm(**kw).fit(coo, epochs=2)
    meshed = _tm(mesh=make_mesh(device="cpu"), **kw).fit(coo, epochs=2)
    assert meshed._staged_fast == plain._staged_fast == ("einsum" if "fast_path" in kw else False)
    for a, b in zip(plain._state, meshed._state):
        assert torch.equal(a, b)


def _local_shuffled(packed: torch.Tensor, keys: torch.Tensor, B: int, n_data: int,
                    sharded: bool = False) -> torch.Tensor:
    """Every data coordinate's ``train._epoch_batches`` under the local
    shuffle (what each rank of a fit computes), joined along the batch into
    the whole ``[n_batches, 8, B]`` block."""
    parts = []
    for d in range(n_data):
        mesh = pmesh.Mesh(n_data, 1, d, torch.device("cpu"))
        data = train.TrainData(packed, None, None, None, None)
        if sharded:
            data = pmesh.shard_train_data(data, mesh, shard_examples=True)
        block, cols = train._epoch_batches(data, train.GenericDraws(keys.reshape(-1)), B, mesh,
                                           "local")
        assert cols == slice(d * B // n_data, (d + 1) * B // n_data)
        parts.append(block)
    return torch.cat(parts, dim=2)


@pytest.mark.parametrize("sharded", [False, True])
def test_shuffle_local_matches_jax_bitwise(sharded):
    """Each rank's locally shuffled batches, whole or example-sharded input,
    are its columns of JAX's ``_shuffle_local`` block, bitwise."""
    n_data, n, B = 2, 4096, 512
    rng = np.random.RandomState(0)
    packed = rng.randint(0, 1000, (8, n)).astype(np.int32)
    packed[2] = np.arange(n)
    jm = jax_parallel.make_mesh(n_data=n_data, devices=jax.devices()[:n_data])
    kperm = jax.random.key(4)
    with jm:
        want = np.asarray(jax_train._shuffle_local(jnp.asarray(packed), kperm, n // B, B, jm))
    keys = torch.tensor(np.asarray(jax.random.bits(kperm, (n_data, n // n_data), jnp.uint32))
                        .astype(np.int64))
    got = _local_shuffled(torch.tensor(packed), keys, B, n_data, sharded)
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    data = train.TrainData(torch.tensor(packed), None, None, None, None)
    with pytest.raises(ValueError, match="divide the data axis"):
        train._epoch_batches(data, train.GenericDraws(keys.reshape(-1)), 500,
                             pmesh.Mesh(3, 1, 0, torch.device("cpu")), "local")


def test_local_shuffle_visits_every_example_once():
    """``tests/test_sharding.py::test_local_shuffle_visits_every_example_once``:
    each of 8 slices sorts only its own columns and fills its columns of
    every batch."""
    n, B, n_data = 4096, 512, 8
    packed = torch.zeros((8, n), dtype=torch.int32)
    packed[0] = torch.arange(n)
    keys = torch.randint(0, 1 << 32, (n_data, n // n_data), generator=torch.Generator().manual_seed(0))
    out = _local_shuffled(packed, keys, B, n_data).numpy()
    ids = out[:, 0, :]
    assert sorted(ids.ravel().tolist()) == list(range(n))
    for r in range(n_data):  # slice r's examples fill columns r of every batch
        cols = ids[:, r * (B // n_data):(r + 1) * (B // n_data)]
        assert ((cols >= r * (n // n_data)) & (cols < (r + 1) * (n // n_data))).all()


def test_build_local_train_data_single_process():
    """``tests/test_sharding.py::test_build_local_train_data_single_process``
    on a mesh of one rank: the local block is the whole block, and
    ``run_epochs`` with the local shuffle trains it."""
    coo = _small_data().tocoo()
    mesh = make_mesh(n_data=1, device="cpu")
    hp = config.Hyperparams(no_components=10, loss="warp", batch_size=512)
    data = build_local_train_data(coo, None, identity_rows(coo.shape[0]),
                                  identity_rows(coo.shape[1]), hp, 512, mesh,
                                  n_examples_global=coo.nnz)
    whole = train.build_train_data(coo, np.ones(coo.nnz, np.float32), identity_rows(coo.shape[0]),
                                   identity_rows(coo.shape[1]), hp, 512, "cpu")
    assert data.examples_sharded and torch.equal(data.packed, whole.packed)
    assert torch.equal(data.positives.idx, whole.positives.idx)
    rng = np.random.RandomState(10)
    state = shard_state(init_state(10, coo.shape[1], coo.shape[0], rng, adagrad=True), mesh,
                        "replicated")
    init = state.item_table.clone()
    seeds = rng.randint(0, 2**31 - 1, size=3).astype(np.uint32)
    state = train.run_epochs(state, data, seeds, hp, 512, mesh=mesh, shuffle="local")
    assert torch.isfinite(state.item_table).all()
    assert float((state.item_table - init).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="exceeds its share"):
        build_local_train_data(coo, None, identity_rows(coo.shape[0]),
                               identity_rows(coo.shape[1]), hp, 512, mesh, n_examples_global=10)


def test_auto_table_partition_resolution(monkeypatch):
    """``tests/test_sharding.py::test_auto_table_partition_resolution``:
    replicated while the state fits the budget; beyond it "rows", which
    trains."""
    train_m = _small_data()
    m = _tm(loss="warp", mesh=make_mesh(device="cpu"), table_partition="auto")
    m.fit(train_m, epochs=1)
    assert m._resolve_table_partition() == "replicated"
    monkeypatch.setenv("LIGHTFM_TPU_REPLICATED_TABLE_BUDGET", "1024")
    m2 = _tm(loss="warp", mesh=make_mesh(device="cpu"), table_partition="auto")
    with pytest.warns(UserWarning, match="model' axis has size 1"):
        m2.fit(train_m, epochs=1)
    assert m2._resolve_table_partition() == "rows" and m2._placement.item.layout == "rows"
    assert np.isfinite(m2.item_embeddings).all()
    assert _tm(loss="warp", table_partition="auto")._resolve_table_partition() == "replicated"


def test_top_k_sharded_on_one_rank_equals_top_k():
    m = _tm(loss="warp").fit(_small_data(), epochs=2)
    uid = torch.arange(40, dtype=torch.int32)
    excl = torch.randint(0, 300, (40, 7), generator=torch.Generator().manual_seed(1))
    state, uf, itf = m._state, identity_rows(300), identity_rows(256)
    mesh = make_mesh(device="cpu")
    block = retrieval.catalog_block(retrieval.build_catalog(state.item_table, itf, 256), 256,
                                    mesh)
    assert (block.rows.shape[0], block.start, block.size) == (256, 0, 256)
    for ex in (None, excl):
        want = retrieval.top_k(state, uf, itf, uid, 10, 256, exclude_idx=ex)
        got = retrieval.top_k_sharded(state, uf, block, uid, 10, mesh, exclude_idx=ex)
        assert torch.equal(got[1], want[1])
        np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# Two ranks: generic epochs against the JAX package's mesh= epochs
# ---------------------------------------------------------------------------

N_DATA = 2

# (loss, example_shuffle, shard_examples, extra hyperparameters)
GENERIC_CASES = [
    ("warp", "global", False, {}),
    ("bpr", "global", False, {}),
    ("logistic", "global", False, {}),
    ("warp-kos", "global", False, {}),
    ("warp", "global", False, dict(learning_schedule="adadelta", item_alpha=1e-3,
                                   user_alpha=1e-3)),
    ("warp", "global", True, {}),
    ("warp", "local", False, {}),
    ("logistic", "local", True, {}),
    ("bpr", "local", True, {}),
]
GEN_USERS, GEN_ITEMS, GEN_B, GEN_D = 200, 300, 512, 8


def _generic_hp(loss, extra):
    return dict(loss=loss, no_components=GEN_D, max_sampled=10, bpr_tries=8, n=5, k=2, **extra)


def _generic_coo(loss):
    return _interactions(GEN_USERS, GEN_ITEMS, 12, seed=4, signed=(loss == "logistic"))


def _jax_generic_draws(key, jd, hp, shuffle, n_pad):
    """The draws of the JAX package's generic epoch under a mesh
    (``train.py:297-299``, ``:249``; ``losses.py``), as
    :class:`train.GenericDraws` arrays; the local shuffle's keys are the
    ``[n_data, n_local]`` bits flattened."""
    B = GEN_B
    n_batches = n_pad // B
    kperm, kbatch = jax.random.split(key)
    keys = jax.random.split(kbatch, n_batches)
    if shuffle == "local":
        perm = np.asarray(jax.random.bits(kperm, (N_DATA, n_pad // N_DATA), jnp.uint32)).ravel()
    else:
        perm = np.asarray(jax.random.bits(kperm, (n_pad,), jnp.uint32))
    out = {"perm": perm.astype(np.int64)}
    shuffled = np.asarray(jax_train._shuffle_global(jd.packed, kperm, n_batches, B))
    neg, tries, kos_u = [], [], []
    for b, bkey in enumerate(keys):
        if hp.loss == "warp":
            neg.append(jax.random.randint(bkey, (hp.max_sampled, B), 0, GEN_ITEMS, jnp.int32))
        elif hp.loss == "bpr":
            tries.append(jax.random.randint(bkey, (B, hp.bpr_tries), 0,
                                            jd.train_items.shape[0], jnp.int32))
        elif hp.loss == "warp-kos":
            kpos, kneg = jax.random.split(bkey)
            bound = np.maximum(np.asarray(jd.positives.lengths)[shuffled[b, 0]], 1)
            slots = np.asarray(jax.random.randint(kpos, (hp.n, B), 0, jnp.asarray(bound)[None, :],
                                                  jnp.int32))
            kos_u.append(((slots + 0.5) / bound[None, :]).astype(np.float32))
            neg.append(jax.random.randint(kneg, (hp.max_sampled, B), 0, GEN_ITEMS, jnp.int32))
    for name, xs in (("neg", neg), ("tries", tries), ("kos_u", kos_u)):
        if xs:
            out[name] = np.stack([np.asarray(x) for x in xs])
    return out


def _generic_epochs(inputs, rank, tmp):
    mesh = make_mesh(n_data=N_DATA, device="cpu")
    out = {}
    for i, (loss, shuffle, sharded, extra) in enumerate(GENERIC_CASES):
        hp = config.Hyperparams(**_generic_hp(loss, extra))
        coo = _generic_coo(loss)
        td = train.build_train_data(coo, np.ones_like(coo.data), identity_rows(GEN_USERS),
                                    identity_rows(GEN_ITEMS), hp, GEN_B, "cpu")
        td = pmesh.shard_train_data(td, mesh, sharded)
        arrays = {n: inputs[f"{i}_{n}"] for n in ModelState._fields}
        draws = train.GenericDraws(*(
            torch.from_numpy(inputs[f"{i}_{n}"]) if f"{i}_{n}" in inputs else None
            for n in train.GenericDraws._fields))
        got = train.generic_epoch(interop.state_from_numpy(arrays, "cpu"), td, draws, hp, GEN_B,
                                  mesh, shuffle)
        out.update({f"{i}_{n}": x.numpy() for n, x in zip(ModelState._fields, got)})
    return out


@pytest.fixture(scope="module")
def generic_epochs(tmp_path_factory):
    """Each case's inputs, the JAX package's epoch on a 2-device mesh, the
    port's one-device epoch, and the two ranks' epochs."""
    inputs, want, single = {}, [], []
    jm = jax_parallel.make_mesh(n_data=N_DATA, devices=jax.devices()[:N_DATA])
    for i, (loss, shuffle, sharded, extra) in enumerate(GENERIC_CASES):
        kw = _generic_hp(loss, extra)
        jhp, thp = jax_config.Hyperparams(**kw), config.Hyperparams(**kw)
        coo = _generic_coo(loss)
        w = np.ones_like(coo.data)
        jd = jax_train.build_train_data(coo, w, lightfm_tpu.sparse.identity_rows(GEN_USERS),
                                        lightfm_tpu.sparse.identity_rows(GEN_ITEMS), jhp, GEN_B)
        arrays = _random_arrays(GEN_ITEMS, GEN_USERS, GEN_D,
                                extra.get("learning_schedule") == "adadelta", seed=6 + i)
        key = jax.random.key(5 + i)
        draws = _jax_generic_draws(key, jd, jhp, shuffle, jd.packed.shape[1])
        jstate = jax_parallel.shard_state(JaxState(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                                          jm, "replicated")
        jdata = jax_parallel.shard_train_data(jd, jm, sharded)
        with jm:
            got = jax_train.run_epoch(jstate, jdata, key, jhp, GEN_B, mesh=jm, shuffle=shuffle,
                                      fast=False)
        want.append({n: np.asarray(x) for n, x in zip(JaxState._fields, got)})
        if shuffle == "global":
            td = train.build_train_data(coo, w, identity_rows(GEN_USERS), identity_rows(GEN_ITEMS),
                                        thp, GEN_B, "cpu")
            tdraws = train.GenericDraws(*(torch.from_numpy(draws[n]) if n in draws else None
                                          for n in train.GenericDraws._fields))
            one = train.generic_epoch(interop.state_from_numpy(arrays, "cpu"), td, tdraws, thp,
                                      GEN_B)
            single.append({n: x.numpy() for n, x in zip(ModelState._fields, one)})
        else:
            single.append(None)
        inputs.update({f"{i}_{n}": np.asarray(v) for n, v in arrays.items()})
        inputs.update({f"{i}_{n}": v for n, v in draws.items()})
    ranks = launch(SCRIPT, "generic_epochs", tmp_path_factory.mktemp("generic"), inputs)
    return inputs, want, single, ranks


@pytest.mark.parametrize("case", range(len(GENERIC_CASES)),
                         ids=["-".join([c[0], c[1], "sharded" if c[2] else "whole"]
                                       + sorted(c[3])) for c in GENERIC_CASES])
def test_two_rank_generic_epoch_matches_jax_mesh_epoch(generic_epochs, case):
    inputs, want, single, ranks = generic_epochs
    for name in ModelState._fields:
        a, b = ranks[0][f"{case}_{name}"], ranks[1][f"{case}_{name}"]
        assert np.array_equal(a, b), ("ranks differ", name)
        _assert_close(a, want[case][name], 2e-5, 2e-6, name)
        if single[case] is not None:
            _assert_close(a, single[case][name], 2e-5, 2e-6, ("one device", name))
    assert not np.array_equal(ranks[0][f"{case}_item_table"], inputs[f"{case}_item_table"])


# ---------------------------------------------------------------------------
# Two ranks: LightFM over a mesh
# ---------------------------------------------------------------------------


def _count_saves():
    from lightfm_tpu_torch import checkpoint

    calls = []
    real = checkpoint.save_model

    def save(model, path):
        calls.append(path)
        real(model, path)

    checkpoint.save_model = save
    return calls


def _multihost_data():
    """``tests/_multihost_worker.py``'s global set: 4,096 random draws over
    128 users x 96 items, duplicates summed."""
    rng = np.random.RandomState(0)
    n_users, n_items, nnz = 128, 96, 4096
    full_m = sp.coo_matrix((np.ones(nnz, np.float32), (rng.randint(0, n_users, nnz),
                                                      rng.randint(0, n_items, nnz))),
                           shape=(n_users, n_items))
    full_m.sum_duplicates()
    return full_m


def _model_fits(inputs, rank, tmp):
    from lightfm_tpu_torch.evaluation import auc_score

    mesh = make_mesh(n_data=N_DATA, device="cpu")
    train_m = _small_data()
    pos = _positives(train_m)
    out = {}

    def fit(name, epochs, **kw):
        m = _tm(loss="warp", mesh=mesh, **kw).fit(train_m, epochs=epochs)
        out[name] = m._state.item_table.numpy()
        out[f"{name}_user"] = m._state.user_table.numpy()
        return m

    # tests/test_sharding.py: trains, matches one device, example-sharded
    # matches replicated, local shuffle trains.
    out["trains_auc"] = np.float64(auc_score(fit("trains", 5), pos).mean())
    fit("match", 3)
    fit("replicated", 2)
    fit("sharded", 2, shard_examples=True)
    m = fit("local", 5, batch_size=512, shard_examples=True, example_shuffle="local")
    out["local_auc"] = np.float64(auc_score(m, pos).mean())
    # Every rank seeds its own RandomState differently: rank 0's draws win.
    fit("own_seeds", 2, random_state=10 + 7 * rank)
    # Each loss on the generic path, every rank the same.
    for loss in ("bpr", "logistic", "warp-kos"):
        m = _tm(loss=loss, mesh=mesh).fit(train_m, epochs=1)
        out[f"loss_{loss}"] = m._state.item_table.numpy()

    # Mid-fit checkpoints: written by rank 0 alone; a resumed run is bit-exact.
    saves = _count_saves()
    full = fit("ckpt_full", 3, random_state=5)
    path = os.path.join(tmp, "cut.npz")
    _tm(loss="warp", mesh=mesh, random_state=5).fit(train_m, epochs=2, checkpoint_every_n_epochs=1,
                                                      checkpoint_path=path)
    out["saves"] = np.int64(len(saves))
    resumed = lightfm_tpu_torch.load_model(path, device="cpu")
    resumed.mesh = mesh
    resumed.fit_partial(train_m, epochs=1, checkpoint_every_n_epochs=1, checkpoint_path=path)
    out["saves_after_resume"] = np.int64(len(saves))
    out["resumed_equal"] = np.bool_(all(torch.equal(a, b)
                                        for a, b in zip(full._state, resumed._state)))

    # recommend on a (1, 2) mesh: top_k_sharded against top_k.
    model_mesh = make_mesh(n_data=1, n_model=N_DATA, device="cpu")
    full.mesh = model_mesh
    users = np.arange(0, 300, 3)
    for tag, kw in (("plain", {}), ("excl", dict(train_interactions=train_m))):
        s, i = full.recommend(users, k=10, **kw)
        out[f"rec_{tag}_s"], out[f"rec_{tag}_i"] = s, i
    full.mesh = None
    for tag, kw in (("plain", {}), ("excl", dict(train_interactions=train_m))):
        s, i = full.recommend(users, k=10, **kw)
        out[f"top_{tag}_s"], out[f"top_{tag}_i"] = s, i

    # tests/test_multihost.py: each rank packs only its slice.
    full_m = _multihost_data()
    n_users, n_items = full_m.shape
    mine = np.arange(full_m.nnz) % N_DATA == mesh.coords["data"]
    local = sp.coo_matrix((full_m.data[mine], (full_m.row[mine], full_m.col[mine])),
                          shape=full_m.shape)
    hp = config.Hyperparams(no_components=8, loss="warp", batch_size=256)
    args = (local, None, identity_rows(n_users), identity_rows(n_items), hp, 256, mesh)
    try:
        build_local_train_data(*args, n_examples_global=full_m.nnz)
    except ValueError as e:
        out["no_global_positives"] = np.str_(str(e))
    data = build_local_train_data(*args, n_examples_global=full_m.nnz,
                                  global_positives=sp.csr_matrix(full_m))
    out["local_width"] = np.int64(data.packed.shape[1])
    state = shard_state(init_state(8, n_items, n_users, np.random.RandomState(10 + rank),
                                   adagrad=True), mesh, "replicated")
    seeds = np.random.RandomState(10).randint(0, 2**31 - 1, 2).astype(np.uint32)
    state = train.run_epochs(state, data, seeds, hp, 256, mesh=mesh, shuffle="local")
    out["multihost"] = state.item_table.numpy()
    out["collectives"] = np.array([mesh.stats["calls"], mesh.stats["bytes"]], np.int64)
    return out


@pytest.fixture(scope="module")
def model_fits(tmp_path_factory):
    return launch(SCRIPT, "model_fits", tmp_path_factory.mktemp("fits"))


def test_two_ranks_agree_bit_for_bit(model_fits):
    """``tests/test_multihost.py``: the replicas are equal in every output."""
    r0, r1 = model_fits
    skip = {"saves", "saves_after_resume", "collectives"}  # per-rank counts
    assert r0.keys() == r1.keys()
    for k in r0.keys() - skip:
        assert np.array_equal(r0[k], r1[k]), k
    assert r0["collectives"][0] > 0


def test_mesh_fit_trains(model_fits):
    """``tests/test_sharding.py::test_sharded_fit_trains`` (replicated)."""
    assert model_fits[0]["trains_auc"] > 0.8


def test_mesh_fit_matches_single_device(model_fits):
    """``tests/test_sharding.py::test_sharded_matches_single_device``."""
    ref = _tm(loss="warp").fit(_small_data(), epochs=3)
    _assert_close(model_fits[0]["match"], ref._state.item_table.numpy(), 2e-5, 2e-6, "items")
    _assert_close(model_fits[0]["match_user"], ref._state.user_table.numpy(), 2e-5, 2e-6, "users")


def test_example_sharded_training_matches_replicated(model_fits):
    """``tests/test_sharding.py::test_example_sharded_training_matches_replicated``."""
    r0 = model_fits[0]
    _assert_close(r0["sharded"], r0["replicated"], 2e-5, 2e-6, "items")


def test_local_shuffle_trains(model_fits):
    """``tests/test_sharding.py::test_local_shuffle_trains`` (replicated tables)."""
    assert model_fits[0]["local_auc"] > 0.8


def test_rank_zero_seeds_and_state_win(model_fits):
    """Ranks whose random_states differ draw rank 0's initial state and
    epochs: the replicas equal each other and a one-device fit seeded as
    rank 0."""
    ref = _tm(loss="warp", random_state=10).fit(_small_data(), epochs=2)
    _assert_close(model_fits[0]["own_seeds"], ref._state.item_table.numpy(), 2e-5, 2e-6, "items")
    assert np.array_equal(model_fits[0]["own_seeds"], model_fits[1]["own_seeds"])


@pytest.mark.parametrize("loss", ["bpr", "logistic", "warp-kos"])
def test_every_loss_trains_over_the_mesh(model_fits, loss):
    ref = _tm(loss=loss).fit(_small_data(), epochs=1)
    _assert_close(model_fits[0][f"loss_{loss}"], ref._state.item_table.numpy(), 2e-5, 2e-6, loss)


def test_mesh_checkpoint_written_once_and_resumed_bit_exact(model_fits):
    r0, r1 = model_fits
    assert (r0["saves"], r1["saves"]) == (2, 0)
    assert (r0["saves_after_resume"], r1["saves_after_resume"]) == (3, 0)
    assert r0["resumed_equal"] and r1["resumed_equal"]


@pytest.mark.parametrize("tag", ["plain", "excl"])
def test_recommend_through_top_k_sharded_equals_top_k(model_fits, tag):
    r0 = model_fits[0]
    assert np.array_equal(r0[f"rec_{tag}_i"], r0[f"top_{tag}_i"])
    np.testing.assert_allclose(r0[f"rec_{tag}_s"], r0[f"top_{tag}_s"], rtol=0, atol=1e-6)


def test_two_process_build_local_train_data(model_fits):
    """``tests/test_multihost.py``: each rank packs its slice; with more
    than one data coordinate the global positives are required; the local
    shuffle trains; the replicas agree bit for bit."""
    r0, r1 = model_fits
    assert "global_positives" in str(r0["no_global_positives"])
    n_pad = -(-_multihost_data().nnz // 256) * 256  # lcm(batch 256, 2 ranks)
    assert r0["local_width"] == r1["local_width"] == n_pad // 2
    t = r0["multihost"]
    assert np.isfinite(t).all() and np.abs(t).max() > 0
    assert np.array_equal(t, r1["multihost"])


if __name__ == "__main__":
    sys.exit(worker({"generic_epochs": _generic_epochs, "model_fits": _model_fits}))
