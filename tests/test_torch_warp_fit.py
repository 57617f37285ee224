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


THREADS = 512  # csrc/warp_fit.cu's kThreads: 16 warps a block
F32 = np.float32


def _warp_score(u1, row):
    """A warp's score of one row, as the kernel takes it: lane l holds the
    fma chain over columns l, l + 32, ...; then the xor butterfly, lane 0's
    sum."""
    W = len(u1)
    lanes = np.zeros(32, F32)
    for c in range(W):  # fma(u1, row, acc): acc + u1*row, one rounding
        lanes[c % 32] = F32(np.float64(u1[c]) * np.float64(row[c]) + np.float64(lanes[c % 32]))
    for o in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[np.arange(32) ^ o]).astype(F32)
    return lanes[0]


def _walk_k5(tables, batches, negs, positives, n_items, G, seed=0):
    """A numpy walk of the cooperative K5 on G blocks: per step, the forward
    with one warp per example (b = warp * G + block), its touches, then
    each block's apply over the rows it owns (row % G == block): its keys
    gathered in an arbitrary order (the kernel's shared-memory atomics),
    ranked by the count of smaller keys, and each run summed in key order.
    Returns the four arrays and, per step, every block's sorted key list."""
    rng = np.random.RandomState(seed)
    ut, ua, it, ia = (np.array(tables[k], F32) for k in
                      ("user_table", "user_acc", "item_table", "item_acc"))
    S, _, B = batches.shape
    W = ut.shape[1]
    lists = []
    for s in range(S):
        bt = batches[s]
        ng = negs[s, 0].reshape(K, B)
        lu = np.zeros((B, W), F32)
        gu = np.zeros((B, W), F32)
        touch = np.full(3 * B, -1, np.int64)
        dealt = sorted(b for blk in range(G) for w in range(THREADS // 32)
                       for b in range(w * G + blk, B, (THREADS // 32) * G))
        assert dealt == list(range(B))  # every example exactly once
        for b in range(B):
            uid, iid = bt[0, b], bt[1, b]
            u1 = ut[uid].copy()
            u1[W - 1] = 1.0
            u_bias = ut[uid, W - 1]
            pos_pred = F32(_warp_score(u1, it[iid]) + u_bias)
            sel = None
            for k in range(K):
                nk = ng[k, b]
                if F32(_warp_score(u1, it[nk]) + u_bias) > F32(pos_pred - F32(1)):
                    if nk not in positives[uid]:
                        sel = (k, nk)
                        break
            L = F32(0)
            y, wt = bt[2:4, b].view(F32)
            if bt[4, b] > 0 and y > 0 and sel is not None:
                rank_w = F32(np.log(F32(max(1.0, np.floor(F32(n_items - 1) / F32(sel[0] + 1))))))
                L = min(F32(wt * rank_w), F32(10.0))
            if L != 0:
                lu[b] = L * u1
                gu[b] = L * np.where(np.arange(W) == W - 1, F32(1), it[sel[1]] - it[iid])
                touch[[b, B + b, 2 * B + b]] = (iid, sel[1], uid)
        owners = {}
        step_lists = []
        for blk in range(G):
            keys = [(int(i >= 2 * B), int(touch[i]), i - 2 * B if i >= 2 * B else i)
                    for i in rng.permutation(3 * B) if touch[i] >= 0 and touch[i] % G == blk]
            ranked = [None] * len(keys)
            for key in keys:
                ranked[sum(other < key for other in keys)] = key
            assert ranked == sorted(keys)  # (side, row, position) order
            step_lists.append(ranked)
            for side, row, pos in ranked:
                assert owners.setdefault((side, row), blk) == blk  # one owner a row
            for (side, row), run in _runs(ranked):
                g1 = np.zeros(W, F32)
                g2 = np.zeros(W, F32)
                for pos in run:  # position order within the run
                    g = gu[pos] if side else (-lu[pos] if pos < B else lu[pos - B])
                    g1 = (g1 + g).astype(F32)
                    g2 = (g2 + (g * g).astype(F32)).astype(F32)
                tab, acc = (ut, ua) if side else (it, ia)
                a = acc[row].copy()
                tab[row] = tab[row] - (F32(LR) * (F32(1) / np.sqrt(a))).astype(F32) * g1
                acc[row] = a + g2
        assert sum(map(len, step_lists)) == int((touch >= 0).sum())
        lists.append(step_lists)
    return (ut, ua, it, ia), lists


def _runs(ranked):
    out = []
    for side, row, pos in ranked:
        if out and out[-1][0] == (side, row):
            out[-1][1].append(pos)
        else:
            out.append(((side, row), [pos]))
    return out


def _hot_steps(setup, n_steps, B):
    """The first steps' first B examples, item 3 the positive of every
    example but each fourth: one row takes most of a step's touches."""
    bt = setup["batches"][:n_steps, :, :B].copy()
    bt[:, 1, np.arange(B) % 4 != 0] = 3
    ng = setup["negs"][:n_steps, 0].reshape(n_steps, K, -1)[:, :, :B].reshape(n_steps, 1, K * B)
    return bt, np.ascontiguousarray(ng)


@pytest.mark.parametrize("G", [1, 3, 8])
@pytest.mark.parametrize("B_step", [128, 100])
def test_partition_walk_equals_plain_bitwise(setup, G, B_step):
    bt, ng = _hot_steps(setup, 3, B_step)
    got, lists = _walk_k5(setup["tables"], bt, ng, setup["positives"], setup["ni"], G, seed=G)
    assert max(len(x) for x in lists[0]) > B_step // 2  # the hot row's block
    t = {k: torch.tensor(v) for k, v in setup["tables"].items()}
    want = wf.warp_fit_fused_plain(
        t["user_table"], t["user_acc"], t["item_table"], t["item_acc"], torch.tensor(bt),
        torch.tensor(ng), torch.tensor(setup["positives"]), n_items=setup["ni"],
        max_sampled=K, learning_rate=LR)
    for name, g, w in zip(("user_table", "user_acc", "item_table", "item_acc"), got, want):
        assert np.array_equal(g, w.numpy()), (name, float(np.abs(g - w.numpy()).max()))


def test_partition_walk_matches_jax_interpret(setup):
    bt, ng = _hot_steps(setup, 3, 128)
    got, _ = _walk_k5(setup["tables"], bt, ng, setup["positives"], setup["ni"], 3)
    t = setup["tables"]
    want = jax_warp_fit_fused(
        *(jnp.asarray(t[k]) for k in ("user_table", "user_acc", "item_table", "item_acc")),
        jnp.asarray(bt), jnp.asarray(ng), jnp.asarray(setup["positives"]), n_items=setup["ni"],
        max_sampled=K, learning_rate=LR, interpret=True)
    for name, g, w in zip(("user_table", "user_acc", "item_table", "item_acc"), got, want):
        w = np.asarray(w)
        assert (np.abs(g - w) <= 1e-5 + 1e-5 * np.abs(w)).all(), name


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
