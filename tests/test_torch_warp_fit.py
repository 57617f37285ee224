"""K5 (lightfm_tpu_torch.ops.warp_fit) vs the JAX package, on the CPU.

The port's wrapper takes its plain version for CPU tensors; it is held
against ``warp_fit_fused`` run in Pallas interpret mode on the setup of
``tests/test_pallas.py:171-227`` (120 users x 100 items, planted, D=8,
B=128, K=10, lr 0.05): both get the same numpy-made batches, negatives and
positives.

Tolerances: after one epoch (10 steps) every table and accumulator entry
agrees to f32 summation order, ``|got - want| <= 1e-5 + 1e-5 * |want|``
(both sum the same terms; the interpret-mode one-hot matmuls gather exactly
and scatter in XLA's dot order).  After the full 8 epochs the port is held
to the JAX test's own bar: train AUC > 0.85 and every user accumulator
>= 1, and to within 0.02 AUC of the JAX fit.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from lightfm_tpu.ops.pallas_train import warp_fit_fused as jax_warp_fit_fused
from lightfm_tpu.sparse import pad_csr_sorted
from lightfm_tpu.state import init_state

from lightfm_tpu_torch.ops import warp_fit as wf

B, K, EPOCHS, LR = 128, 10, 8, 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    worker processes side by side, and each one's OpenMP pool spinning on
    every core slows all of them by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """``tests/test_pallas.py:180-210``, as numpy arrays."""
    rng = np.random.RandomState(7)
    nu, ni, d = 120, 100, 6
    top = np.argsort(-(rng.randn(nu, d) @ rng.randn(ni, d).T), axis=1)
    rows = np.repeat(np.arange(nu), 10)
    cols = top[:, :10].ravel()
    train = sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)), shape=(nu, ni))
    state = init_state(8, ni, nu, np.random.RandomState(0), adagrad=True)
    coo = train.tocoo()
    n = coo.nnz
    n_pad = ((n + B - 1) // B) * B
    packed = np.zeros((8, n_pad), np.int32)
    packed[0, :n], packed[1, :n] = coo.row, coo.col
    packed[2, :n] = np.ones(n, np.float32).view(np.int32)
    packed[3, :n] = np.ones(n, np.float32).view(np.int32)
    packed[4, :n] = 1
    prng = np.random.RandomState(10)
    steps = []
    for _ in range(EPOCHS):
        shuf = packed[:, prng.permutation(n_pad)]
        steps.append(shuf.reshape(8, n_pad // B, B).transpose(1, 0, 2))
    batches = np.ascontiguousarray(np.concatenate(steps, 0))
    negs = prng.randint(0, ni, size=(batches.shape[0], 1, K * B)).astype(np.int32)
    positives = np.asarray(pad_csr_sorted(train, pad_multiple=8).idx)
    tables = {k: np.asarray(getattr(state, k))
              for k in ("user_table", "user_acc", "item_table", "item_acc")}
    return dict(train=train, ni=ni, tables=tables, batches=batches, negs=negs,
                positives=positives, steps_per_epoch=n_pad // B)


def _args(setup, n_steps, to):
    t = setup["tables"]
    return (
        *(to(t[k]) for k in ("user_table", "user_acc", "item_table", "item_acc")),
        to(setup["batches"][:n_steps]), to(setup["negs"][:n_steps]), to(setup["positives"]),
    )


def _jax(setup, n_steps):
    out = jax_warp_fit_fused(
        *_args(setup, n_steps, jnp.asarray), n_items=setup["ni"], max_sampled=K,
        learning_rate=LR, interpret=True,
    )
    return [np.asarray(x) for x in out]


def _port(setup, n_steps, fn=wf.warp_fit_fused):
    out = fn(*_args(setup, n_steps, torch.tensor), n_items=setup["ni"], max_sampled=K,
             learning_rate=LR)
    return [x.numpy() for x in out]


def _auc(u, it, train):
    scores = u[:, :-1] @ it[:, :-1].T + u[:, -1:] + it[None, :, -1]
    aucs = []
    for uu in range(train.shape[0]):
        pos = train.indices[train.indptr[uu]: train.indptr[uu + 1]]
        mask = np.ones(train.shape[1], bool)
        mask[pos] = False
        aucs.append((scores[uu][pos][:, None] > scores[uu][mask][None, :]).mean())
    return float(np.mean(aucs))


def test_one_epoch_matches_jax_interpret(setup):
    n = setup["steps_per_epoch"]
    got, want = _port(setup, n), _jax(setup, n)
    for name, g, w in zip(("user_table", "user_acc", "item_table", "item_acc"), got, want):
        err = np.abs(g - w) - 1e-5 * np.abs(w)
        assert (err <= 1e-5).all(), (name, float(err.max()))
        assert not np.array_equal(g, setup["tables"][name])  # the epoch moved it
    # The inputs are left alone.
    assert np.array_equal(_args(setup, 1, torch.tensor)[0].numpy(), setup["tables"]["user_table"])


def test_whole_fit_learns_like_jax(setup):
    u, ua, it, ia = _port(setup, len(setup["batches"]))
    assert np.isfinite(u).all() and np.isfinite(it).all()
    assert (ua >= 1.0).all() and (ia >= 1.0).all()
    auc = _auc(u, it, setup["train"])
    ju, _, jit_, _ = _jax(setup, len(setup["batches"]))
    jax_auc = _auc(ju, jit_, setup["train"])
    assert auc > 0.85, (auc, jax_auc)
    assert abs(auc - jax_auc) < 0.02, (auc, jax_auc)


def test_masked_examples_and_zero_steps_are_noops(setup):
    """y <= 0 or invalid examples update nothing; zero steps return copies
    of the inputs."""
    n = setup["steps_per_epoch"]
    masked = dict(setup)
    b = setup["batches"][:n].copy()
    b[:, 2] = np.full(b[:, 2].shape, -1.0, np.float32).view(np.int32)
    masked["batches"] = b
    for x, name in zip(_port(masked, n), ("user_table", "user_acc", "item_table", "item_acc")):
        assert np.array_equal(x, setup["tables"][name]), name
    for x, name in zip(_port(setup, 0), ("user_table", "user_acc", "item_table", "item_acc")):
        assert np.array_equal(x, setup["tables"][name]), name


def test_wrapper_checks_arguments_and_counts_no_cpu_launch(setup):
    args = list(_args(setup, 2, torch.tensor))
    kw = dict(n_items=setup["ni"], max_sampled=K, learning_rate=LR)
    wf.reset_launches()
    with pytest.raises(TypeError, match="int32"):
        wf.warp_fit_fused(*args[:4], args[4].long(), *args[5:], **kw)
    with pytest.raises(ValueError, match="K\\*B"):
        wf.warp_fit_fused(*args, **{**kw, "max_sampled": K - 1})
    with pytest.raises(ValueError, match="one row per user"):
        wf.warp_fit_fused(*args[:6], args[6][:5], **kw)
    wf.warp_fit_fused(*args, **kw)
    assert wf.launches == {"warp_fit_fused": 0}  # plain versions are not launches
