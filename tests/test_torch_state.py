"""lightfm_tpu_torch.state vs lightfm_tpu.state, on the CPU.

The port's init draws its seed exactly as the JAX package does and feeds a
torch.Generator, so it is held to the same distribution and shapes, not to
the same numbers.  Folding is deterministic and compared value for value.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightfm_tpu import state as jax_state

from lightfm_tpu_torch import state


@pytest.mark.parametrize("D", [1, 6, 7, 10, 63, 64, 65, 128])
def test_table_width_matches_jax(D):
    assert state.table_width(D) == jax_state.table_width(D)
    assert state.table_width(D) % 8 == 0 and state.table_width(D) > D


@pytest.mark.parametrize("adagrad", [True, False])
def test_init_state_layout_and_distribution(adagrad):
    D, n_items, n_users = 16, 3000, 2000
    rs_j, rs_t = np.random.RandomState(5), np.random.RandomState(5)
    js = jax_state.init_state(D, n_items, n_users, rs_j, adagrad=adagrad)
    ts = state.init_state(D, n_items, n_users, rs_t, adagrad=adagrad)
    # Both consume the same draw from the RandomState.
    assert rs_j.randint(0, 2**31 - 1) == rs_t.randint(0, 2**31 - 1)
    assert ts._fields == js._fields
    for name in ts._fields:
        got, want = getattr(ts, name), np.asarray(getattr(js, name))
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape, name
    for table, jtable in ((ts.item_table, js.item_table), (ts.user_table, js.user_table)):
        t, j = table.numpy(), np.asarray(jtable)
        emb = t[:, :D]
        # (U[0,1) - 0.5) / D: bounded, centred, variance 1 / (12 D^2).
        assert np.abs(emb).max() < 0.5 / D
        assert abs(emb.mean()) < 0.01 / D
        assert abs(emb.var() - 1.0 / (12 * D * D)) < 0.05 / (12 * D * D)
        assert abs(emb.var() - j[:, :D].var()) < 0.05 / (12 * D * D)
        assert (t[:, D:] == 0).all() and (j[:, D:] == 0).all()  # pad + bias
    grad_init = 1.0 if adagrad else 0.0
    assert (ts.item_acc == grad_init).all() and (ts.user_acc == grad_init).all()
    assert (ts.item_mom == 0).all() and (ts.user_mom == 0).all()
    assert float(ts.item_log_scale) == 0.0 and ts.item_log_scale.dim() == 0


def test_init_state_is_seeded():
    a = state.init_state(8, 50, 40, np.random.RandomState(1), adagrad=True)
    b = state.init_state(8, 50, 40, np.random.RandomState(1), adagrad=True)
    c = state.init_state(8, 50, 40, np.random.RandomState(2), adagrad=True)
    assert torch.equal(a.item_table, b.item_table)
    assert torch.equal(a.user_table, b.user_table)
    assert not torch.equal(a.item_table, c.item_table)


def _fold_inputs(item_log_scale, user_log_scale):
    rng = np.random.RandomState(3)
    item = rng.randn(20, 8).astype(np.float32)
    user = rng.randn(10, 8).astype(np.float32)
    item[0, 0] = np.inf  # inf * exp(-huge) = inf * 0 -> patched to 0
    user[1, 2] = np.nan  # a genuine NaN stays NaN
    zeros_i, zeros_u = np.zeros_like(item), np.zeros_like(user)
    arrays = dict(
        item_table=item, item_acc=zeros_i, item_mom=zeros_i,
        user_table=user, user_acc=zeros_u, user_mom=zeros_u,
        item_log_scale=np.float32(item_log_scale),
        user_log_scale=np.float32(user_log_scale),
    )
    js = jax_state.ModelState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    ts = state.ModelState(**{k: torch.tensor(v) for k, v in arrays.items()})
    return js, ts


@pytest.mark.parametrize("scales", [(0.0, 0.0), (0.7, 2.5), (200.0, 13.9), (20.0, 1.0)])
@pytest.mark.parametrize("fn", ["fold_scales", "maybe_fold_scales"])
def test_fold_scales_matches_jax(scales, fn):
    js, ts = _fold_inputs(*scales)
    want = getattr(jax_state, fn)(js)
    got = getattr(state, fn)(ts)
    for name in ts._fields:
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            rtol=1e-6, atol=0, equal_nan=True, err_msg=name,
        )
