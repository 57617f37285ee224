"""lightfm_tpu_torch.ops.representation vs lightfm_tpu.ops.representation,
on the CPU, for identity, padded and chunked features."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from lightfm_tpu import sparse as jax_sparse
from lightfm_tpu.ops import representation as jax_rep

from lightfm_tpu_torch import sparse
from lightfm_tpu_torch.ops import representation as rep

N_ROWS, N_FEATS, W = 50, 40, 16


def _features(kind):
    if kind == "identity":
        return sparse.identity_rows(N_ROWS), jax_sparse.identity_rows(N_ROWS)
    rng = np.random.RandomState(4)
    m = sp.random(N_ROWS, N_FEATS, density=0.08, random_state=rng, format="lil",
                  dtype=np.float32)
    m[np.arange(N_ROWS), np.arange(N_ROWS) % N_FEATS] = 1.0
    if kind == "chunked":
        m[9, :] = rng.rand(N_FEATS).astype(np.float32)
    kwargs = {"width_cap": 4, "chunk_width": 8} if kind == "chunked" else {"pad_multiple": 8}
    csr = m.tocsr()
    t, j = sparse.pad_csr(csr, **kwargs), jax_sparse.pad_csr(csr, **kwargs)
    assert type(t).__name__ == ("ChunkedRows" if kind == "chunked" else "PaddedRows")
    return t, j


def _table(n):
    return np.random.RandomState(1).randn(n, W).astype(np.float32)


@pytest.mark.parametrize("kind", ["identity", "padded", "chunked"])
@pytest.mark.parametrize("scaled", [False, True])
def test_batch_representation_matches_jax(kind, scaled):
    tf, jf = _features(kind)
    table = _table(N_ROWS if kind == "identity" else N_FEATS)
    ids = np.random.RandomState(2).randint(0, N_ROWS, (6, 5)).astype(np.int32)
    scale = np.float32(0.5) if scaled else None
    got = rep.batch_representation(
        torch.tensor(table), tf, torch.tensor(ids),
        None if scale is None else torch.tensor(scale),
    )
    want = jax_rep.batch_representation(
        jnp.asarray(table), jf, jnp.asarray(ids), None if scale is None else jnp.float32(scale)
    )
    assert tuple(got.shape) == (6, 5, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["identity", "padded", "chunked"])
def test_full_representations_matches_jax(kind):
    tf, jf = _features(kind)
    table = _table(N_ROWS if kind == "identity" else N_FEATS)
    # block=16 walks several row blocks, as a large catalog does.
    got = rep.full_representations(torch.tensor(table), tf, block=16)
    want = jax_rep.full_representations(jnp.asarray(table), jf, block=16)
    assert tuple(got.shape) == (N_ROWS, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_score_pairs_and_unit_bias_match_jax():
    rng = np.random.RandomState(5)
    u = rng.randn(30, W).astype(np.float32)
    i = rng.randn(30, W).astype(np.float32)
    np.testing.assert_array_equal(
        rep.with_unit_bias(torch.tensor(u)).numpy(),
        np.asarray(jax_rep.with_unit_bias(jnp.asarray(u))),
    )
    got = rep.score_pairs(torch.tensor(u), torch.tensor(i)).numpy()
    want = np.asarray(jax_rep.score_pairs(jnp.asarray(u), jnp.asarray(i)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    exact = (u[:, :-1].astype(np.float64) * i[:, :-1]).sum(1) + u[:, -1] + i[:, -1]
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-5)


def test_f32_dot_is_a_plain_matmul_on_the_cpu():
    a, b = torch.randn(4, 9), torch.randn(9, 3)
    assert torch.equal(rep.f32_dot(a, b), a @ b)


@pytest.mark.parametrize("kind", ["padded", "chunked"])
def test_feature_reductions_ignore_a_global_tf32_flag(kind, monkeypatch):
    """Padded and chunked reductions are IEEE fp32 matmuls through f32_dot,
    so turning TF32 on globally changes neither result nor the flag."""
    tf, _ = _features(kind)
    table = torch.tensor(_table(N_FEATS))
    ids = torch.tensor(np.random.RandomState(2).randint(0, N_ROWS, (6, 5)))
    flags = torch.backends.cuda.matmul
    monkeypatch.setattr(flags, "allow_tf32", False)
    want = rep.batch_representation(table, tf, ids), rep.full_representations(table, tf)

    calls = []
    f32_dot = rep.f32_dot
    monkeypatch.setattr(rep, "f32_dot", lambda a, b: calls.append(1) or f32_dot(a, b))
    monkeypatch.setattr(flags, "allow_tf32", True)
    got = rep.batch_representation(table, tf, ids), rep.full_representations(table, tf)
    assert calls, "feature reductions bypassed f32_dot"
    assert flags.allow_tf32
    for g, w in zip(got, want):
        assert torch.equal(g, w)
