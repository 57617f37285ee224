"""The rank-count kernel's launch plan and operand staging, on the CPU.

The kernel itself runs only on the card; what surrounds it is Python and
is held here: the (user tiles x item splits) plan must cover every user and
catalog row exactly once and fill the card, the template shapes must exist
and fit in shared memory, and counting block by block over the staged
k-major operands, as the kernel walks them, must give the plain counts.
"""

import numpy as np
import pytest
import torch

from lightfm_tpu_torch.ops import rank_counts as rc
from lightfm_tpu_torch.ops import ranking
from lightfm_tpu_torch.state import table_width

_SHAPES = [(1, 1), (256, 100_352), (4_096, 100_352), (49_920, 100_352), (1_000, 5_000), (16, 63)]


@pytest.mark.parametrize("n_sms", [132, 8])
@pytest.mark.parametrize("U,I", _SHAPES)
def test_launch_plan_covers_and_fills(U, I, n_sms):
    bu, bi = 128, rc.BLOCK_ITEMS
    plan = rc.launch_plan(U, I, n_sms, 2, bu)
    item_tiles = -(-I // bi)
    starts = [y * plan.tiles_per_split * bi for y in range(plan.item_splits)]
    ends = [min(I, s + plan.tiles_per_split * bi) for s in starts]
    assert starts[0] == 0 and ends[-1] == I
    assert all(e == s for e, s in zip(ends, starts[1:]))  # each row exactly once
    assert all(s % bi == 0 for s in starts)  # splits start on tile boundaries
    assert all(e > s for s, e in zip(starts, ends))  # no split is empty
    assert (plan.user_tiles - 1) * bu < U <= plan.user_tiles * bu
    if plan.user_tiles * item_tiles >= n_sms:
        assert plan.blocks >= n_sms
    assert plan.blocks == plan.user_tiles * plan.item_splits


def test_launch_plan_serving_targets():
    # 132 SMs, two blocks each: the shapes of one predict_rank.
    assert rc.launch_plan(256, 100_352, 132, 2).item_splits >= 120  # heavy tier
    assert rc.launch_plan(4_096, 100_352, 132, 2).item_splits >= 8  # hybrid, T = 1
    light = rc.launch_plan(49_920, 100_352, 132, 2)
    waves = light.blocks / 264
    assert waves - int(waves) >= 0.9  # the last wave at least 90% full


@pytest.mark.parametrize("Wa", [1, 9, 73, 128, 129, 265, 280, 281, 716, 721, 2049])
def test_kernel_shape_has_a_template_and_fits(Wa):
    for T in range(1, rc.MAX_T + 1):
        s = rc.kernel_shape(T, Wa)
        assert s.t_pad >= T and (s.t_pad <= 2 or s.t_pad % 4 == 0)
        if s.block_users == 128:
            assert s.t_pad in (1, 2, 4, 8, 12) and Wa <= 128
        else:
            assert s.block_users == 64 and s.t_pad in (16, 20, 24, 28, 32)
        assert 1 <= s.chunk_rows <= rc.MAX_CHUNK_ROWS
        assert -(-Wa // s.chunk_rows) == -(-Wa // rc.MAX_CHUNK_ROWS)  # fewest chunks
        user_rows = 2 * s.chunk_rows if s.stream_users else Wa
        assert s.smem_bytes == 4 * (s.block_users * (s.t_pad + user_rows)
                                    + 2 * s.chunk_rows * rc.BLOCK_ITEMS)
        assert s.smem_bytes <= rc.MAX_BLOCK_SMEM and s.blocks_per_sm == 2
        # The user tile streams only where a resident one leaves room for
        # fewer than two blocks an SM.
        resident = s.smem_bytes + 4 * s.block_users * (Wa - user_rows)
        assert s.stream_users == (rc.SM_SMEM // (resident + 1024) < 2)
    assert rc.kernel_shape(10, 73).block_users == 128  # the serving shape
    assert not rc.kernel_shape(10, 73).stream_users
    assert rc.kernel_shape(32, 280).stream_users is False
    assert rc.kernel_shape(32, 281).stream_users is True


def test_kernel_shape_rejects_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        rc.kernel_shape(rc.MAX_T + 1, 73)
    with pytest.raises(ValueError):
        rc.kernel_shape(10, 0)


def _counts_by_plan(u_aug, items_aug, ts, n_sms):
    """The kernel's walk in plain torch: per block (user tile, item split),
    per 64-item tile of the staged k-major operands, items past I scoring
    NaN, thresholds padded with +inf; partial counts summed."""
    U, Wa = u_aug.shape
    I, T = items_aug.shape[0], ts.shape[1]
    shape = rc.kernel_shape(T, Wa)
    plan = rc.launch_plan(U, I, n_sms, shape.blocks_per_sm, shape.block_users)
    u_t, it_t = rc.stage_k_major(u_aug, items_aug)
    bu, bi = shape.block_users, rc.BLOCK_ITEMS
    ts_pad = torch.full((U, shape.t_pad), float("inf"))
    ts_pad[:, :T] = ts
    item_tiles = -(-I // bi)
    counts = torch.zeros((U, T), dtype=torch.int64)
    for x in range(plan.user_tiles):
        users = slice(x * bu, (x + 1) * bu)
        for y in range(plan.item_splits):
            for tile in range(y * plan.tiles_per_split,
                              min((y + 1) * plan.tiles_per_split, item_tiles)):
                cols = it_t[:, tile * bi:(tile + 1) * bi]
                s = u_t[:, :U][:, users].T @ cols
                s[:, tile * bi + torch.arange(cols.shape[1]) >= I] = float("nan")
                hit = s[:, None, :] >= ts_pad[users][:, :, None]
                counts[users] += hit.sum(-1)[:, :T]
    return counts.float(), plan


@pytest.mark.parametrize(
    "U,I,T,Wa,n_sms",
    [(1, 1, 1, 9, 132), (5, 65, 10, 73, 132), (130, 300, 3, 9, 8),
     (70, 1000, 17, 40, 16), (16, 63, 32, 5, 132), (300, 257, 2, 130, 4),
     (21, 200, 10, 721, 8)],  # D = 712: the user tile streams
)
def test_k_major_staging_by_plan_equals_plain(U, I, T, Wa, n_sms):
    rng = np.random.RandomState(U + I + T)
    u = torch.from_numpy(rng.randint(-2, 3, (U, Wa)).astype(np.float32))
    items = torch.from_numpy(rng.randint(-2, 3, (I, Wa)).astype(np.float32))
    u[:, -1] = 1.0  # a -inf pad row, as pad_catalog_neg_inf makes it, is an ordinary row
    items[-1] = 0.0
    items[-1, -1] = -np.inf
    ts = torch.from_numpy((rng.randint(-12, 13, (U, T)) / 2).astype(np.float32))
    ts[0, 0] = np.inf  # an invalid slot counts 0
    u_t, it_t = rc.stage_k_major(u, items)
    assert u_t.is_contiguous() and u_t.shape == (Wa, -(-U // 4) * 4)
    assert torch.equal(u_t[:, :U], u.T) and not u_t[:, U:].any()
    assert it_t.is_contiguous() and it_t.shape == (Wa, -(-I // 4) * 4)
    assert torch.equal(it_t[:, :I], items.T) and not it_t[:, I:].any()
    got, plan = _counts_by_plan(u, items, ts, n_sms)
    want = rc.rank_counts_plain(u, items, ts)
    assert torch.equal(got, want)
    assert torch.equal(rc.rank_counts(u, items, ts), want)
    assert got[0, 0] == 0
    assert plan.blocks >= 1


# Tiers of at most MAX_T test slots go to the kernels on the card at any
# width, as the reference's do on the TPU; tiers of more slots take the
# matmul paths; a CPU device never does (the CPU tests run _ranks_flat /
# _ranks_blocked there, and _ranks_fused through its plain versions).
@pytest.mark.parametrize(
    "D, T, device, fused",
    [
        (64, 10, "cuda", True),  # the serving shape: Wa = 73
        (704, 10, "cuda", True),  # W = 712, Wa = 713
        (707, 1, "cuda", True),
        (712, 10, "cuda", True),  # W = 720, Wa = 721: the user tile streams
        (712, 1, "cuda", True),
        (64, rc.MAX_T, "cuda", True),
        (64, rc.MAX_T + 1, "cuda", False),  # T = 33
        (64, 10, "cpu", False),
        (704, 10, "cpu", False),
    ],
)
def test_fused_tier_predicate(D, T, device, fused):
    W = table_width(D)
    assert ranking._fused_tier(T, device) is fused
    if fused:
        rc.kernel_shape(T, W + 1)  # the kernel takes what the predicate sends it
    elif device == "cuda":
        with pytest.raises(ValueError, match="T"):
            rc.kernel_shape(T, W + 1)


_PAIR_WIDTHS = [73, 300, 721]
_PAIR_SLOTS = [1, 10, 32, 416]
STAGE_ROWS = 8  # csrc/rank_counts.cu's kStage: rows a warp loads before storing
WARPS = rc.PAIR_BLOCK // 32


def _block_users(U, C):
    """Users spanned by each pair_scores block: (first user, count)."""
    x0 = np.arange(0, U * C, rc.PAIR_BLOCK, dtype=np.int64)
    last = np.minimum(x0 + rc.PAIR_BLOCK, U * C) - 1
    return x0 // C, last // C - x0 // C + 1


@pytest.mark.parametrize("C", _PAIR_SLOTS)
@pytest.mark.parametrize("Wa", _PAIR_WIDTHS)
def test_pair_plan_fits_and_covers(Wa, C):
    for U in (1, 3, 256, 49_920, 50_000):
        plan = rc.pair_plan(U, C, Wa)
        assert plan.smem_bytes <= rc.MAX_BLOCK_SMEM
        assert plan.smem_bytes == 4 * (rc.PAIR_BLOCK + (rc.PAIR_BLOCK + plan.users) * plan.stride)
        # The chunks cover the row: the fewest of at most MAX_CHUNK_ROWS columns.
        n_chunks = -(-Wa // plan.chunk_cols)
        assert plan.chunk_cols <= rc.MAX_CHUNK_ROWS
        assert n_chunks == -(-Wa // rc.MAX_CHUNK_ROWS)
        assert plan.stride % 8 == 4 and plan.chunk_cols <= plan.stride < plan.chunk_cols + 8
        # Every flat pair lies in exactly one block, and no block spans more
        # users than the plan stages.
        assert (plan.blocks - 1) * rc.PAIR_BLOCK < U * C <= plan.blocks * rc.PAIR_BLOCK
        _, users = _block_users(U, C)
        assert len(users) == plan.blocks and users.max() <= plan.users <= rc.PAIR_BLOCK


def test_pair_plan_rejects_empty():
    with pytest.raises(ValueError):
        rc.pair_plan(0, 10, 73)
    with pytest.raises(ValueError):
        rc.pair_plan(10, 10, 0)


def _staged_rows(n_rows):
    """The kernel's staging walk (``stage_rows``): per round, warp w loads
    rows w * 8 .. w * 8 + 7 of an operand's rows, then stores them; returns
    each row's (round, warp)."""
    seen = {}
    for w in range(WARPS):
        for rnd, r0 in enumerate(range(w * STAGE_ROWS, n_rows, WARPS * STAGE_ROWS)):
            for r in range(r0, min(r0 + STAGE_ROWS, n_rows)):
                assert r not in seen  # every row staged once
                seen[r] = (rnd, w)
    assert sorted(seen) == list(range(n_rows))
    return seen


@pytest.mark.parametrize("C", _PAIR_SLOTS)
@pytest.mark.parametrize("Wa", _PAIR_WIDTHS)
def test_pair_staging_walk_reads_back_each_pair(Wa, C):
    """The kernel's shared-memory layout walked in numpy: per block and
    chunk, the gathered item row of each pair at row ``tid``, then each
    user row once, ``stride`` floats apart, each staged once by the warp
    walk; reading back a pair's two rows chunk by chunk gives the rows
    of ``u_aug`` and ``items_aug`` (an index outside [0, I) stages nothing
    and scores NaN), and the 8 threads of a quarter warp, reading a float4
    each at the same k, hit 8 distinct 16-byte bank groups."""
    rng = np.random.RandomState(Wa + C)
    U = max(2, 700 // C)
    I = 257
    u = rng.randint(-2, 3, (U, Wa)).astype(np.float32)
    items = rng.randint(-2, 3, (I, Wa)).astype(np.float32)
    idx = rng.randint(0, I, (U, C)).astype(np.int32)
    idx.flat[::97] = I  # out of range
    plan = rc.pair_plan(U, C, Wa)
    P, stride = rc.PAIR_BLOCK, plan.stride
    assert len(set((np.arange(8) * stride // 4) % 8)) == 8
    flat = idx.ravel()
    out = np.full(U * C, np.nan, np.float32)
    starts, spans = _block_users(U, C)
    for blk, (u0, n_users) in enumerate(zip(starts, spans)):
        x = np.arange(blk * P, min((blk + 1) * P, U * C))
        ids = flat[x]
        n_pairs = len(x)
        item_rows, user_rows = _staged_rows(n_pairs), _staged_rows(n_users)
        assert max(rnd for rnd, _ in item_rows.values()) < P // (WARPS * STAGE_ROWS)
        acc = np.zeros(n_pairs, np.float64)
        for k0 in range(0, Wa, plan.chunk_cols):
            cols = min(plan.chunk_cols, Wa - k0)
            it_s = np.full((P, stride), np.nan, np.float32)
            u_s = np.full((plan.users, stride), np.nan, np.float32)
            for r in item_rows:
                if 0 <= ids[r] < I:
                    it_s[r, :cols] = items[ids[r], k0:k0 + cols]
            for r in user_rows:
                u_s[r, :cols] = u[u0 + r, k0:k0 + cols]
            for t, (xx, i) in enumerate(zip(x, ids)):
                if not 0 <= i < I:
                    continue
                a, b = u_s[xx // C - u0, :cols], it_s[t, :cols]
                assert np.array_equal(a, u[xx // C, k0:k0 + cols])
                assert np.array_equal(b, items[i, k0:k0 + cols])
                acc[t] += float(a.astype(np.float64) @ b.astype(np.float64))
        ok = (ids >= 0) & (ids < I)
        out[x[ok]] = acc[ok]
    want = rc.pair_scores_plain(torch.from_numpy(u), torch.from_numpy(items),
                                torch.from_numpy(np.minimum(idx, I - 1))).numpy().ravel()
    bad = flat >= I
    assert np.isnan(out[bad]).all()
    assert np.array_equal(out[~bad], want[~bad])  # integer-valued: exact


def test_fused_tier_widths():
    assert (table_width(704) + 1, table_width(712) + 1) == (713, 721)
    assert rc.kernel_shape(10, 713).stream_users and rc.kernel_shape(10, 721).stream_users
