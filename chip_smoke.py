"""Smoke run of lightfm_tpu_torch's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the CUDA kernels from ``lightfm_tpu_torch/csrc`` (into the ignored
``lightfm_tpu_torch/_build``), holds each rank kernel against its plain
PyTorch version at the serving shape of ``benchmarks/bench_serving.py``
(50,000 users x 100,000 items, D=64, T=10), then drives
``LightFM.predict_rank`` with the four metrics, ``recommend`` and
``predict`` at that width with random weights made from ``--seed``, and
checks what comes out.  Then it holds the adagrad update kernel (K1, and
K4 over it) and the gradient-sums kernel (K3) against their plain versions
at the training step's shape, and trains with ``LightFM.fit`` at the
``synth-5m-warp-d64`` shape of ``benchmarks/bench_training.py`` (200,000
users x 100,000 items, 5M interactions, D=64, batch 131,072): 15 WARP
epochs with a train-sample AUC guard, a same-seed determinism check, one
epoch each of BPR, logistic and ``user_pallas=False``, per-epoch CUDA-event
times and one step broken into spans.  The same data then trains the hybrid
path at the ``warp-hybrid`` shape of ``bench.py`` (item features: identity +
2,048 tags): 15 WARP epochs through K3 with an AUC guard, ``predict_rank``
with the item features through the rank kernels, determinism, one BPR
epoch and its own step spans.  Last, the whole-fit WARP kernel (K5)
runs a 30-epoch fit at the size of the synthetic MovieLens 100k (943 users
x 1,682 items, D=10) in one launch, against its plain version.  Any failed
check raises, so the exit code is non-zero; the last stdout line is the
device record, the line before it the per-kernel record.

Needs a CUDA device: without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp

N_USERS, N_ITEMS, D, T_TEST, N_TRAIN = 50_000, 100_000, 64, 10, 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)

# Training shape: `synth-5m-warp-d64` (benchmarks/bench_training.py:84-87,
# bench.py:348) -- 200k users x 100k items, 5M clustered interactions,
# D=64 (W=72), batch 131,072, WARP K=10 over a pool of 16,384.
TRAIN_USERS, TRAIN_ITEMS, TRAIN_NNZ, TRAIN_BATCH = 200_000, 100_000, 5_000_000, 131_072
TRAIN_EPOCHS = 15  # the JAX package's accuracy-guard epoch count (bench.py)
AUC_FLOOR = 0.97  # train-sample AUC over 2,048 users (JAX package: 0.9924)
LR = 0.05  # LightFM's default learning rate
DEVICE = "cuda"  # phase 4's tensors; a CPU rehearsal points it at "cpu"

# Hybrid shape: `warp-hybrid` (bench.py:414, 152-182) on the training data
# above -- item features identity + N_TAGS tags (one block tag and 5 noise
# tags per item), D=64, batch 131,072, 15 WARP epochs.
N_TAGS = 2048
HYBRID_EPOCHS = 15
HYBRID_AUC_FLOOR = 0.94  # JAX package on the TPU: 0.954 (BENCH_r05.json)

# Whole-fit kernel (K5) shape: the quickstart's synthetic MovieLens 100k
# (bench.py:93-113, lightfm_tpu/datasets/synthetic.py:19-29) -- 943 users x
# 1,682 items, ~19k positives after the min_rating 5 cut, D=10, K=10, 30
# epochs.
FIT_USERS, FIT_ITEMS, FIT_D, FIT_K, FIT_EPOCHS = 943, 1682, 10, 10, 30


def log(*parts):
    print(*parts, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def fp32_peak_flops(torch) -> float:
    """FP32 CUDA-core rate: SM count x 128 lanes x 2 (FMA) x max SM clock."""
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"  fp32 peak: {sms} SMs x 128 lanes x 2 x {mhz:.0f} MHz")
    return sms * 128 * 2 * mhz * 1e6


def time_ms(torch, fn, reps: int = 5) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    log(f"  ok: {what}")


def kernel_checks(torch, seed: int, i_pad: int) -> list[dict]:
    """Phase 2: each kernel against its plain version on the card."""
    from lightfm_tpu_torch.ops import rank_counts as rc

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: IEEE fp32
    U, I, Wa, T = N_USERS, i_pad, 73, T_TEST
    g = torch.Generator(device=dev).manual_seed(seed)
    log(f"phase 2: kernels vs plain at U={U} I={I} Wa={Wa} T={T}")

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev)

    idx = randint(0, I, (U, T)).int()

    # (a) integer-valued: every dot is exact in fp32, ties are plentiful.
    u = randint(-2, 3, (U, Wa)).float()
    items = randint(-2, 3, (I, Wa)).float()
    ts = randint(-40, 41, (U, T)).float() / 2
    ts[:, : T // 2] = rc.pair_scores(u, items, idx[:, : T // 2].contiguous())
    got = rc.rank_counts(u, items, ts)
    want = rc.rank_counts_plain(u, items, ts)
    bad = int((got != want).sum())
    log(f"  integer rank_counts mismatches: {bad}")
    check(bad == 0, "integer-valued rank_counts equals plain exactly")
    ps_bad = int((rc.pair_scores(u, items, idx) != rc.pair_scores_plain(u, items, idx)).sum())
    log(f"  integer pair_scores mismatches: {ps_bad}")
    check(ps_bad == 0, "integer-valued pair_scores equals plain exactly")

    # (b) gaussian: the plain version sums in cuBLAS's order, so near-ties
    # may flip by one (tests/test_pallas.py:35-36 uses the same tolerance).
    u = torch.randn((U, Wa), generator=g, device=dev)
    items = torch.randn((I, Wa), generator=g, device=dev)
    ts = rc.pair_scores(u, items, idx)
    got = rc.rank_counts(u, items, ts)
    want = rc.rank_counts_plain(u, items, ts)
    diff = (got - want).abs()
    frac = float((diff > 0).float().mean())
    rc_err = float(diff.max())
    log(f"  gaussian rank_counts max|d|={rc_err} frac differing={frac:.3g}")
    check(rc_err <= 1 and frac <= 1e-4, "gaussian rank_counts within |d|<=1 on <=1e-4")
    check(bool((got >= 1).all()), "every self score counts itself (bitwise pair_scores)")
    ps_got = rc.pair_scores(u, items, idx)
    ps_want = rc.pair_scores_plain(u, items, idx)
    ps_err = float((ps_got - ps_want).abs().max())
    tol = 1e-5 * float(ps_want.abs().max())
    log(f"  gaussian pair_scores max|d|={ps_err:.3g} (tol {tol:.3g})")
    check(ps_err <= tol, "gaussian pair_scores within 1e-5 of max|score|")

    # (c) zero embeddings: every score is exactly 0, every test slot ties all.
    zu, zi = torch.zeros_like(u), torch.zeros_like(items)
    zc = rc.rank_counts(zu, zi, torch.zeros_like(ts))
    check(bool((zc == I).all()), "zero embeddings count every item")

    # (d) other widths and slot counts (the >48 KB shared-memory launch
    # path, the T=1 and T=32 templates), integer-valued so exact.
    for wa, t in ((265, 32), (9, 1), (40, 17)):
        su = randint(-2, 3, (1000, wa)).float()
        si = randint(-2, 3, (5000, wa)).float()
        sts = rc.pair_scores(su, si, randint(0, 5000, (1000, t)).int())
        same = torch.equal(rc.rank_counts(su, si, sts), rc.rank_counts_plain(su, si, sts))
        check(same, f"Wa={wa}, T={t}: rank_counts equals plain exactly")

    # Times on the gaussian inputs.
    peak = fp32_peak_flops(torch)
    k_ms = time_ms(torch, lambda: rc.rank_counts(u, items, ts))
    p_ms = time_ms(torch, lambda: rc.rank_counts_plain(u, items, ts), reps=2)

    def scores_matmul():
        s = u @ items.T
        del s

    lib_ms = time_ms(torch, scores_matmul, reps=3)
    rc_bytes = 4 * (U * Wa + I * Wa + U * T + U * T)
    rc_ops = 2 * U * I * Wa + U * I * T
    rc_bound = max(rc_bytes / HBM_BYTES_PER_S, rc_ops / peak) * 1e3
    log(f"  rank_counts kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
        f"matmul {lib_ms:.3f} ms, bound {rc_bound:.3f} ms "
        f"(fp32 peak {peak / 1e12:.1f} TFLOP/s)")

    ps_k_ms = time_ms(torch, lambda: rc.pair_scores(u, items, idx))
    ps_p_ms = time_ms(torch, lambda: rc.pair_scores_plain(u, items, idx))
    rows = int(torch.unique(idx).numel())
    ps_bytes = 4 * (U * Wa + rows * Wa + U * T + U * T)
    ps_ops = 2 * U * T * Wa
    ps_bound = max(ps_bytes / HBM_BYTES_PER_S, ps_ops / peak) * 1e3
    log(f"  pair_scores kernel {ps_k_ms:.4f} ms, plain {ps_p_ms:.4f} ms, "
        f"bound {ps_bound:.4f} ms")
    del zu, zi, u, items
    torch.cuda.empty_cache()

    return [
        {
            "name": "rank_counts", "route": "cuda",
            "source": "lightfm_tpu_torch/csrc/rank_counts.cu",
            "replaces": "lightfm_tpu/ops/pallas_rank.py:63",
            "launches": 0, "max_abs_err": rc_err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": rc_bound,
            "bound_by": "operations" if rc_ops / peak > rc_bytes / HBM_BYTES_PER_S else "bytes",
            "library_ms": lib_ms,
        },
        {
            "name": "pair_scores", "route": "cuda",
            "source": "lightfm_tpu_torch/csrc/rank_counts.cu",
            "replaces": "lightfm_tpu/ops/ranking.py:293",
            "launches": 0, "max_abs_err": ps_err,
            "ms": ps_k_ms, "plain_ms": ps_p_ms, "bound_ms": ps_bound,
            "bound_by": "operations" if ps_ops / peak > ps_bytes / HBM_BYTES_PER_S else "bytes",
            "library_ms": None,
        },
    ]


def planted_data(seed: int):
    """Random weights with a planted cluster structure, plus test and train
    interactions drawn inside each user's cluster: T_TEST test items and
    N_TRAIN train items per user, and 400 train items for 0.5% heavy users
    (they get their own degree tier)."""
    from lightfm_tpu_torch.state import table_width

    rng = np.random.RandomState(seed)
    W, n_clusters = table_width(D), 64
    centroids = rng.randn(n_clusters, D).astype(np.float32)
    user_c = rng.randint(0, n_clusters, N_USERS)
    item_c = np.arange(N_ITEMS) % n_clusters

    def table(clusters):
        n = len(clusters)
        t = np.zeros((n, W), np.float32)
        t[:, :D] = (centroids[clusters] + 0.5 * rng.randn(n, D)) / np.sqrt(D)
        t[:, -1] = 0.1 * rng.randn(n)
        return t

    item_table, user_table = table(item_c), table(user_c)
    arrays = {
        "item_table": item_table, "item_acc": np.ones_like(item_table),
        "item_mom": np.zeros_like(item_table), "user_table": user_table,
        "user_acc": np.ones_like(user_table), "user_mom": np.zeros_like(user_table),
        "item_log_scale": np.float32(0), "user_log_scale": np.float32(0),
    }

    heavy = set(rng.choice(N_USERS, N_USERS // 200, replace=False).tolist())
    t_rows, t_cols, r_rows, r_cols = [], [], [], []
    for u in range(N_USERS):
        c = user_c[u]
        n_tr = 400 if u in heavy else N_TRAIN
        j = rng.choice((N_ITEMS - c + n_clusters - 1) // n_clusters, T_TEST + n_tr, replace=False)
        items = c + n_clusters * j
        t_rows.append(np.full(T_TEST, u))
        t_cols.append(items[:T_TEST])
        r_rows.append(np.full(n_tr, u))
        r_cols.append(items[T_TEST:])

    def csr(rows, cols):
        rows, cols = np.concatenate(rows), np.concatenate(cols)
        return sp.csr_matrix(
            (np.ones(len(rows), np.float32), (rows, cols)), shape=(N_USERS, N_ITEMS)
        )

    return arrays, csr(t_rows, t_cols), csr(r_rows, r_cols)


def check_ranks_float64(ranks, test, train, user_table, item_table, users):
    """Ranks of sampled users against float64 numpy: equal, except where a
    catalog score lies within 1e-5 * max|score| of the test score.  Returns
    the counts of exact and near-tie ranks and the widest band of near ties."""
    u = user_table[users].astype(np.float64)
    it = item_table.astype(np.float64)
    scores = u[:, :-1] @ it[:, :-1].T + u[:, -1:] + it[None, :, -1]
    n_exact = n_near = widest = 0
    for r, user in enumerate(users):
        s = scores[r]
        s[train.indices[train.indptr[user] : train.indptr[user + 1]]] = -np.inf
        tol = 1e-5 * np.abs(s[np.isfinite(s)]).max()
        for p in range(test.indptr[user], test.indptr[user + 1]):
            ts = s[test.indices[p]]
            lo = int((s > ts + tol).sum())
            hi = int((s >= ts - tol).sum()) - 1
            got = ranks.data[p]
            if not lo <= got <= hi:
                raise AssertionError(f"user {user}: rank {got} outside [{lo}, {hi}]")
            n_exact += lo == hi
            n_near += lo != hi
            widest = max(widest, hi - lo)
    return n_exact, n_near, widest


def counted(rc, fn, *args, **kwargs):
    """Run one path with every kernel launch count set to 0 just before it;
    return its result and the counts it launched."""
    rc.reset_launches()
    out = fn(*args, **kwargs)
    return out, dict(rc.launches)


def timed_predict_rank(torch, ranking, model, test, train):
    """One ``predict_rank`` call with its parts timed: the host prep on the
    host clock (device synchronised after it), and on CUDA events each
    degree tier's ranking (``_ranks_fused``) and, inside it, every
    ``rank_counts`` and ``pair_scores`` launch.  The wrappers only record
    events around the ranking module's own calls; launches are counted by
    the kernel wrappers as always."""
    spans, prep = [], [0.0]
    names = ("rank_counts", "pair_scores", "_ranks_fused", "_prepare_rank_tiers")
    saved = {n: getattr(ranking, n) for n in names}
    shape = {
        "rank_counts": lambda a: f"U={a[0].shape[0]} I={a[1].shape[0]} T={a[2].shape[1]}",
        "pair_scores": lambda a: f"U={a[0].shape[0]} C={a[2].shape[1]}",
        "_ranks_fused": lambda a: f"U={a[3].shape[0]} T={a[4].shape[1]} Ptr={a[6].shape[1]}",
    }

    def on_device(name):
        def run(*a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = saved[name](*a, **kw)
            ev[1].record()
            spans.append((name, shape[name](a), ev))
            return out
        return run

    def prep_on_host(*a, **kw):
        t0 = time.perf_counter()
        out = saved["_prepare_rank_tiers"](*a, **kw)
        torch.cuda.synchronize()
        prep[0] += time.perf_counter() - t0
        return out

    patches = {n: on_device(n) for n in shape}
    patches["_prepare_rank_tiers"] = prep_on_host
    try:
        for n, f in patches.items():
            setattr(ranking, n, f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ranks = model.predict_rank(test, train_interactions=train)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for n, f in saved.items():
            setattr(ranking, n, f)
    parts = [{"span": n, "shape": d, "ms": ev[0].elapsed_time(ev[1])} for n, d, ev in spans]
    tiers_ms = sum(p["ms"] for p in parts if p["span"] == "_ranks_fused")
    return ranks, {
        "wall_ms": wall_ms, "host_prep_ms": prep[0] * 1e3, "spans": parts,
        "rest_ms": wall_ms - prep[0] * 1e3 - tiers_ms,
    }


def serving_path(torch, seed: int) -> dict:
    """Phase 3: predict_rank + metrics, recommend and predict at full width.
    Each path runs with the launch counts set to 0 just before it; returns
    the counts of the main path, one ``predict_rank`` call."""
    from lightfm_tpu_torch import LightFM, evaluation, interop
    from lightfm_tpu_torch.ops import rank_counts as rc
    from lightfm_tpu_torch.ops import ranking

    t0 = time.perf_counter()
    arrays, test, train = planted_data(seed)
    log(f"phase 3: serving path, {N_USERS} users x {N_ITEMS} items, D={D}, "
        f"test nnz {test.nnz}, train nnz {train.nnz} "
        f"(data made in {time.perf_counter() - t0:.1f} s)")
    model = LightFM(no_components=D, loss="warp", random_state=seed)
    check(model.device == "cuda", "LightFM() defaults to the CUDA device")
    model._state = interop.state_from_numpy(arrays, model.device)
    model.n_users_, model.n_items_ = N_USERS, N_ITEMS

    path_launches = {}
    ranking.stats["clamped"] = 0
    (ranks, first), main = counted(rc, timed_predict_rank, torch, ranking, model, test, train)
    path_launches["predict_rank"] = main
    (again, second), path_launches["predict_rank (prep cached)"] = counted(
        rc, timed_predict_rank, torch, ranking, model, test, train
    )
    for what, b in (("first call", first), ("second call, prep cached", second)):
        log(f"  predict_rank {what}: " + json.dumps(b))
    log(f"  kernel launches of one predict_rank: {main}; clamped: {ranking.stats['clamped']}")
    check(main["rank_counts"] > 0 and main["pair_scores"] > 0,
          "predict_rank went through both kernels")
    check(path_launches["predict_rank (prep cached)"] == main,
          "the cached call launches the same kernels")
    check(np.array_equal(ranks.data, again.data), "two predict_rank calls give equal ranks")
    check(ranking.stats["clamped"] == 0, "the self-match clamp never changed a rank")
    n_train = np.diff(train.indptr)[np.repeat(np.arange(N_USERS), np.diff(ranks.indptr))]
    check(bool((ranks.data >= 0).all() and (ranks.data <= N_ITEMS - 1 - n_train).all()),
          "every rank lies in [0, n_items - 1 - n_train(u)]")
    sample = np.random.RandomState(seed + 1).choice(N_USERS, 256, replace=False)
    n_exact, n_near, _ = check_ranks_float64(
        ranks, test, train, arrays["user_table"], arrays["item_table"], sample
    )
    check(n_exact > 0.9 * (n_exact + n_near),
          f"256 users' ranks equal float64 numpy ({n_exact} exact, {n_near} near-ties in bounds)")

    metrics = {}
    for name, fn, kw in (
        ("precision@10", evaluation.precision_at_k, {"k": 10}),
        ("recall@10", evaluation.recall_at_k, {"k": 10}),
        ("auc", evaluation.auc_score, {}),
        ("reciprocal_rank", evaluation.reciprocal_rank, {}),
    ):
        values, path_launches[name] = counted(rc, fn, model, test, train, **kw)
        metrics[name] = values.mean()
    log("  metrics: " + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
    check(all(np.isfinite(v) for v in metrics.values()), "all four metrics are finite")
    check(metrics["auc"] > 0.9, "AUC on the planted model > 0.9")

    zero = LightFM(no_components=D, random_state=seed)
    zero._state = interop.state_from_numpy(
        {k: np.zeros_like(v) for k, v in arrays.items()}, zero.device
    )
    zr, path_launches["predict_rank (zero model)"] = counted(rc, zero.predict_rank, test)
    check(bool((zr.data == N_ITEMS - 1).all()), "a zeroed model ranks every test item n_items - 1")

    users = np.arange(min(4096, N_USERS))
    k = 100
    results = {}
    train_rows = train[users]
    for mode in ("exact", "approx", "compressed"):
        model.recommend(users, k=k, mode=mode, train_interactions=train)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (s, ids), path_launches[f"recommend ({mode})"] = counted(
            rc, model.recommend, users, k=k, mode=mode, train_interactions=train
        )
        log(f"  recommend({mode}, k={k}) for {len(users)} users: "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        results[mode] = ids
        check(ids.shape == (len(users), k) and bool((ids >= 0).all() and (ids < N_ITEMS).all()),
              f"{mode}: ids in range")
        hit = np.asarray(train_rows[np.repeat(np.arange(len(users)), k), ids.ravel()]).ravel()
        check(not hit.any(), f"{mode}: no excluded item returned")
        check(bool((np.diff(s, axis=1) <= 0).all()), f"{mode}: scores non-increasing")
        p = model.predict(np.repeat(users, k), ids.ravel()).reshape(s.shape)
        check(bool(np.allclose(s, p, rtol=1e-5, atol=1e-5 * np.abs(p).max())),
              f"{mode}: scores equal predict() on the same pairs to 1e-5")

    def recall(a, b):
        return np.mean([len(set(x) & set(y)) / k for x, y in zip(a, b)])

    r_approx = recall(results["exact"], results["approx"])
    r_comp = recall(results["exact"], results["compressed"])
    log(f"  recall vs exact: approx {r_approx:.4f}, compressed {r_comp:.4f}")
    check(r_approx == 1.0, "approx (exact top-k in the port) returns the exact top-k")
    check(r_comp >= 0.9, "compressed recall vs exact >= 0.9")

    rng = np.random.RandomState(seed + 2)
    pu = rng.randint(0, N_USERS, 1_000_000)
    pi = rng.randint(0, N_ITEMS, 1_000_000)
    t0 = time.perf_counter()
    got, path_launches["predict"] = counted(rc, model.predict, pu, pi)
    log(f"  predict on 1M pairs: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    ut, it = arrays["user_table"].astype(np.float64), arrays["item_table"].astype(np.float64)
    want = (ut[pu, :-1] * it[pi, :-1]).sum(1) + ut[pu, -1] + it[pi, -1]
    err = np.abs(got - want).max() / np.abs(want).max()
    check(bool(np.isfinite(got).all()) and err <= 1e-5,
          f"predict agrees with float64 numpy (max error {err:.2e} of max|score|)")
    check(ranking.stats["clamped"] == 0, "no predict_rank call of phase 3 clamped a rank")
    log("  kernel launches by path (each counted from 0): " + json.dumps(path_launches))
    return main


def zipf_touches(rng, M: int, R: int, W: int):
    """M sorted touches of an R-row table: Zipf row popularity (the hottest
    rows get thousands of touches), 1% touches at rows >= R with NONZERO
    gradients (they must be ignored), every 17th gradient zero."""
    rows = rng.permutation(R)[(rng.zipf(1.1, M) - 1) % R]
    n_sent = M // 100
    rows[:n_sent] = R + rng.randint(0, 2**30 - R, n_sent)
    rows[0] = R  # the smallest out-of-range row
    wg = (0.1 * rng.randn(M, W)).astype(np.float32)
    wg[::17] = 0.0
    return np.sort(rows).astype(np.int32), wg


def update_tolerance(torch, table, acc, sidx, wg):
    """Per-element bound on |kernel - plain|: each side sums a row's n_r
    touches in fp32 in its own order, so each is within (n_r + 2) * 2^-23 *
    (sum of |terms| + |start value|) of the exact result (recursive-
    summation worst case plus the final multiply and add); twice that
    bounds their difference."""
    R, W = table.shape
    keep = sidx < R
    rows = sidx[keep].long()
    g = wg[keep].double()
    n = torch.zeros(R, dtype=torch.float64, device=table.device)
    n.index_add_(0, rows, torch.ones_like(rows, dtype=torch.float64))
    abs_sum = torch.zeros((R, W), dtype=torch.float64, device=table.device)
    abs_sum.index_add_(0, rows, g.abs())
    sq_sum = torch.zeros_like(abs_sum).index_add_(0, rows, g * g)
    scale = 2 * (n[:, None] + 2) * 2.0**-23
    t_tol = scale * (table.double().abs() + LR * torch.rsqrt(acc.double()) * abs_sum)
    a_tol = scale * (acc.double() + sq_sum)
    return t_tol, a_tol


def update_kernel_checks(torch, seed: int) -> float:
    """Phase 4: K1 against its plain version at the training step's shape
    (M = 131,072 touches, W = 72, the item and the user table) on skewed
    touches, at both precisions; K4 once.  Returns the largest difference
    seen."""
    from lightfm_tpu_torch.ops import adagrad_update as au
    from lightfm_tpu_torch.state import table_width

    dev = torch.device(DEVICE)
    rng = np.random.RandomState(seed + 3)
    M, W = TRAIN_BATCH, table_width(D)
    log(f"phase 4: adagrad update kernel vs plain at M={M} W={W}, Zipf touches")
    worst = 0.0
    for R in (TRAIN_ITEMS, TRAIN_USERS):
        sidx_np, wg_np = zipf_touches(rng, M, R, W)
        sidx, wg = torch.from_numpy(sidx_np).to(dev), torch.from_numpy(wg_np).to(dev)
        table0 = torch.from_numpy((0.1 * rng.randn(R, W)).astype(np.float32)).to(dev)
        acc0 = torch.from_numpy((1.0 + rng.rand(R, W)).astype(np.float32)).to(dev)
        in_range = sidx[sidx < R]
        runs = torch.unique_consecutive(in_range, return_counts=True)[1]
        untouched = torch.ones(R, dtype=torch.bool, device=dev)
        untouched[in_range.long()] = False
        log(f"  R={R}: {runs.numel()} distinct rows, hottest row {int(runs.max())} touches, "
            f"{int((sidx >= R).sum())} out-of-range touches, {int(untouched.sum())} untouched rows")
        t_tol, a_tol = update_tolerance(torch, table0, acc0, sidx, wg)

        def run(fn, s=sidx, g=wg, prec="default"):
            t, a = table0.clone(), acc0.clone()
            fn(t, a, s, g, LR, prec)
            torch.cuda.synchronize()
            return t, a

        for prec in ("highest", "default"):
            t1, a1 = run(au.sorted_adagrad_update, prec=prec)
            t2, a2 = run(au.sorted_adagrad_update, prec=prec)
            check(torch.equal(t1, t2) and torch.equal(a1, a2),
                  f"R={R} {prec}: two launches are bitwise equal")
            tp, ap = run(au.sorted_adagrad_update_plain, prec=prec)
            dt, da = (t1 - tp).abs(), (a1 - ap).abs()
            worst = max(worst, float(dt.max()), float(da.max()))
            check(bool((dt <= t_tol).all() and (da <= a_tol).all()),
                  f"R={R} {prec}: kernel equals plain within the summation-order bound "
                  f"(max |d| table {float(dt.max()):.3g}, acc {float(da.max()):.3g})")
            check(torch.equal(t1[untouched], table0[untouched])
                  and torch.equal(a1[untouched], acc0[untouched]),
                  f"R={R} {prec}: untouched rows are bitwise unchanged")
        for what, s, g in (
            ("zero gradients", sidx, torch.zeros_like(wg)),
            ("every row out of range", torch.full_like(sidx, 2**30), wg),
        ):
            t1, a1 = run(au.sorted_adagrad_update, s, g)
            check(torch.equal(t1, table0) and torch.equal(a1, acc0),
                  f"R={R}: an all-masked call ({what}) changes nothing")
        tw, aw = table0.clone(), acc0.clone()
        z_ms = time_ms(torch, lambda: au.sorted_adagrad_update(tw, aw, sidx, wg, LR, "default"), reps=10)
        z_plain = time_ms(torch, lambda: au.sorted_adagrad_update_plain(tw, aw, sidx, wg, LR, "default"), reps=5)
        log(f"  R={R} Zipf touches: kernel {z_ms:.4f} ms, plain {z_plain:.4f} ms")

        if R == TRAIN_ITEMS:  # K4 once: the same touches in random order
            order = torch.from_numpy(rng.permutation(M)).to(dev)
            s, g = sidx[order].contiguous(), wg[order].contiguous()
            t1, a1 = run(au.adagrad_update, s, g)
            tp, ap = run(au.sorted_adagrad_update_plain, s, g)
            err = max(float((t1 - tp).abs().max()), float((a1 - ap).abs().max()))
            check(bool(((t1 - tp).abs() <= t_tol).all() and ((a1 - ap).abs() <= a_tol).all()),
                  f"K4 (argsort + K1) equals plain within the same bound (max |d| {err:.3g})")
            worst = max(worst, err)
        del t_tol, a_tol
        torch.cuda.empty_cache()
    return worst


def sums_tolerance(torch, sidx, wg, n_rows: int):
    """Per-element bound on |kernel - plain| for K3: each side sums a row's
    n_r terms (wg, and wg^2 in the second half) in fp32 in its own order, so
    each is within (n_r + 1) * 2^-23 * sum|terms| of the exact sum; twice
    that bounds their difference."""
    keep = sidx < n_rows
    rows = sidx[keep].long()
    g = wg[keep].double()
    n = torch.zeros(n_rows, dtype=torch.float64, device=wg.device)
    n.index_add_(0, rows, torch.ones_like(rows, dtype=torch.float64))
    terms = torch.zeros((n_rows, 2 * wg.shape[1]), dtype=torch.float64, device=wg.device)
    terms.index_add_(0, rows, torch.cat([g.abs(), g * g], dim=1))
    return 2 * (n[:, None] + 1) * 2.0**-23 * terms


def check_grad_sums(torch, gs, sidx, wg, n_rows: int, what: str) -> float:
    """K3 against its plain version on one set of touches, at both
    precisions: two launches bitwise equal, within the summation-order
    bound, untouched rows exactly 0, out-of-range touches ignored.  Returns
    the largest difference."""
    tol = sums_tolerance(torch, sidx, wg, n_rows)
    in_range = sidx < n_rows
    untouched = torch.ones(n_rows, dtype=torch.bool, device=sidx.device)
    untouched[sidx[in_range].long()] = False
    worst = 0.0
    for prec in ("highest", "default"):
        a = gs.sorted_grad_sums(sidx, wg, n_rows, prec)
        b = gs.sorted_grad_sums(sidx, wg, n_rows, prec)
        check(torch.equal(a, b), f"K3 {what} {prec}: two launches are bitwise equal")
        d = (a - gs.sorted_grad_sums_plain(sidx, wg, n_rows, prec)).abs()
        worst = max(worst, float(d.max()))
        check(bool((d <= tol).all()),
              f"K3 {what} {prec}: kernel equals plain within the summation-order bound "
              f"(max |d| {float(d.max()):.3g})")
        check(not bool(a[untouched].any()), f"K3 {what} {prec}: untouched rows are exactly 0")
        if not bool(in_range.all()):
            c = gs.sorted_grad_sums(sidx[in_range].contiguous(), wg[in_range].contiguous(),
                                    n_rows, prec)
            check(torch.equal(a, c), f"K3 {what} {prec}: out-of-range touches are ignored")
    return worst


def grad_sums_checks(torch, seed: int) -> dict:
    """Phase 4b: K3 against its plain version at the hybrid step's shape
    (M = 131,072 touches, W = 72, n_rows = 100,000) on Zipf touches;
    all-out-of-range and empty calls.  Returns the largest difference."""
    from lightfm_tpu_torch.ops import grad_sums as gs
    from lightfm_tpu_torch.state import table_width

    dev = torch.device(DEVICE)
    rng = np.random.RandomState(seed + 5)
    M, W, R = TRAIN_BATCH, table_width(D), TRAIN_ITEMS
    log(f"phase 4b: gradient-sums kernel (K3) vs plain at M={M} W={W} n_rows={R}, Zipf touches")
    sidx_np, wg_np = zipf_touches(rng, M, R, W)
    sidx, wg = torch.from_numpy(sidx_np).to(dev), torch.from_numpy(wg_np).to(dev)
    runs = torch.unique_consecutive(sidx[sidx < R], return_counts=True)[1]
    log(f"  {runs.numel()} distinct rows, hottest row {int(runs.max())} touches, "
        f"{int((sidx >= R).sum())} out-of-range touches")
    worst = check_grad_sums(torch, gs, sidx, wg, R, "Zipf")
    for what, s in (("every row out of range", torch.full_like(sidx, 2**30)),
                    ("no touches", sidx[:0])):
        out = gs.sorted_grad_sums(s, wg[: s.shape[0]], R, "default")
        check(out.shape == (R, 2 * W) and not bool(out.any()), f"K3: {what} gives exact zeros")
    k_ms = time_ms(torch, lambda: gs.sorted_grad_sums(sidx, wg, R, "default"), reps=10)
    p_ms = time_ms(torch, lambda: gs.sorted_grad_sums_plain(sidx, wg, R, "default"), reps=5)
    log(f"  Zipf touches: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    return worst


def clustered_interactions(n_users: int, n_items: int, nnz: int, seed: int, n_clusters: int = 64):
    """A copy of ``bench.py:116-149`` (``_clustered_interactions``, unsigned):
    users belong to clusters, each preferring a contiguous item range (80%
    of draws in range), so the model can learn at any scale."""
    rng = np.random.RandomState(seed)
    cluster = rng.randint(0, n_clusters, n_users)
    span = n_items // n_clusters
    rows = rng.randint(0, n_users, nnz).astype(np.int32)
    in_pref = rng.rand(nnz) < 0.8
    lo = cluster[rows] * span
    cols = np.where(in_pref, lo + rng.randint(0, span, nnz), rng.randint(0, n_items, nnz)).astype(np.int32)
    coo = sp.coo_matrix((np.ones(nnz, np.float32), (rows, cols)), shape=(n_users, n_items))
    coo.sum_duplicates()
    return coo


def tag_features(n_items: int, n_tags: int = N_TAGS, tags_per_item: int = 5, seed: int = 3):
    """A copy of ``bench.py:152-182`` (``_tag_features``): identity + one
    deterministic block tag per item (blocks nest inside the planted
    cluster ranges of :func:`clustered_interactions`) + random noise tags,
    about ``tags_per_item + 2`` entries per row."""
    rng = np.random.RandomState(seed)
    n_blocks = n_tags // 2
    block = np.minimum(np.arange(n_items) * n_blocks // n_items, n_blocks - 1)
    noise = n_blocks + rng.randint(0, n_tags - n_blocks, (n_items, tags_per_item))
    cols = np.concatenate([block[:, None], noise], axis=1).ravel()
    rows = np.repeat(np.arange(n_items), tags_per_item + 1)
    tags = sp.coo_matrix(
        (np.ones(rows.size, np.float32), (rows, cols.astype(np.int64))), shape=(n_items, n_tags)
    ).tocsr()
    return sp.hstack([sp.identity(n_items, dtype=np.float32, format="csr"), tags], format="csr")


def auc_sample(model, train_csr, n_sample: int = 2048, seed: int = 0, item_features=None) -> float:
    """Train AUC over a random user sample, as ``bench.py:185-208``: rows
    outside the sample are zeroed, so exactly the sampled users are ranked
    over the full catalog (through the port's own ``auc_score``)."""
    from lightfm_tpu_torch.evaluation import auc_score

    users = np.random.RandomState(seed).choice(train_csr.shape[0], n_sample, replace=False)
    keep = np.zeros(train_csr.shape[0], np.float32)
    keep[users] = 1.0
    sub = sp.diags(keep).dot(train_csr).tocsr()
    sub.eliminate_zeros()
    return float(auc_score(model, sub, item_features=item_features,
                           check_intersections=False).mean())


def launch_counts():
    """Every kernel wrapper's launch counts, merged."""
    from lightfm_tpu_torch.ops import adagrad_update, grad_sums, rank_counts, warp_fit

    mods = (adagrad_update, grad_sums, rank_counts, warp_fit)
    return mods, lambda: {k: v for m in mods for k, v in m.launches.items()}


def counted_all(fn, *args, **kwargs):
    """Run one path with every kernel's launch count set to 0 just before
    it; return its result and the counts it launched."""
    mods, read = launch_counts()
    for m in mods:
        m.reset_launches()
    out = fn(*args, **kwargs)
    return out, read()


class Spans:
    """CUDA events around calls of module functions, in call order.  Each
    record is ``{"label", "start", "stop", "host_ms", "args"}``: ``host_ms``
    is the call's time on the host clock (the host enqueues work and
    returns, so where it is close to the events' time the device was
    waiting on the host); ``args`` are kept only for the calls made inside
    the ``capture_at = (label, n)``-th call (0-based) of that label, else
    None."""

    def __init__(self, torch, capture_at=None):
        self.torch = torch
        self.records = []
        self.capture_at = capture_at
        self._calls = {}
        self._capture = False

    @contextlib.contextmanager
    def patch(self, targets):
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]

        def wrap(label, fn):
            def run(*a, **kw):
                n = self._calls.get(label, 0)
                self._calls[label] = n + 1
                outer = self._capture
                if (label, n) == self.capture_at:
                    self._capture = True
                rec = {"label": label, "args": a if self._capture else None,
                       "start": self.torch.cuda.Event(enable_timing=True),
                       "stop": self.torch.cuda.Event(enable_timing=True)}
                self.records.append(rec)
                t0 = time.perf_counter()
                rec["start"].record()
                try:
                    return fn(*a, **kw)
                finally:
                    rec["stop"].record()
                    rec["host_ms"] = (time.perf_counter() - t0) * 1e3
                    self._capture = outer
            return run

        try:
            for (mod, name, label), (_, _, fn) in zip(targets, saved):
                setattr(mod, name, wrap(label, fn))
            yield self
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)


def step_breakdown(spans: Spans, epoch: int) -> dict:
    """Per-part CUDA-event times of the steps of one epoch of a traced WARP
    fit: the shuffle, then per step the forward and pool scoring (step
    start to the item K1), K1 on the items, the pool scatter, the user
    gradient permute (pool scatter end to the user K1), K1 on the users."""
    epochs, cur = [], None
    for rec in spans.records:
        if rec["label"] == "epoch":
            cur = {"shuffle": None, "steps": []}
            epochs.append(cur)
        elif rec["label"] == "shuffle":
            cur["shuffle"] = rec
        elif rec["label"] == "step":
            cur["steps"].append([rec])
        else:
            cur["steps"][-1].append(rec)
    ep = epochs[epoch]

    def ms(a, b):
        return a.elapsed_time(b)

    parts = []
    for step, k1_items, scatter, k1_users in ep["steps"]:
        parts.append({
            "forward and pool scoring": ms(step["start"], k1_items["start"]),
            "K1 items": ms(k1_items["start"], k1_items["stop"]),
            "pool scatter": ms(scatter["start"], scatter["stop"]),
            "user gradient permute": ms(scatter["stop"], k1_users["start"]),
            "K1 users": ms(k1_users["start"], k1_users["stop"]),
            "whole step": ms(step["start"], step["stop"]),
        })
    names = list(parts[0])
    return {
        "shuffle_ms": ms(ep["shuffle"]["start"], ep["shuffle"]["stop"]),
        "steps": len(parts),
        "step_1": parts[1],
        "mean_over_steps": {n: float(np.mean([p[n] for p in parts])) for n in names},
    }


def profiled_epoch(torch, train, model, seed: int) -> None:
    """One more WARP epoch of the fitted model (through ``train.run_epochs``
    on its staged data, so no host prep) under ``torch.profiler``: the
    epoch's host-clock wall time, the device's busy time (the union of the
    kernel and copy intervals the profiler saw), the idle share, and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    args = (model._state, model._staged_train_data, [seed + 11], model._staged_hp,
            model._staged_batch_size, model._staged_fast)
    train.run_epochs(*args)  # warm-up outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train.run_epochs(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy_us, end = 0.0, -float("inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    if not spans:
        log(f"  profiled epoch: {wall_ms:.3f} ms wall; the profiler saw no device time")
        return
    busy_ms = busy_us / 1e3
    log(f"  profiled epoch: {wall_ms:.3f} ms wall (host clock), device busy {busy_ms:.3f} ms "
        f"over {len(spans)} device intervals, idle share {1 - busy_ms / wall_ms:.4f}")

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    top = sorted(
        (e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA),
        key=dev_us, reverse=True,
    )[:12]
    log("  top device kernels of the epoch (name, calls, ms): " + json.dumps(
        [(e.key[:60], e.count, dev_us(e) / 1e3) for e in top]))


def training_path(torch, seed: int) -> dict:
    """Phase 5: ``LightFM.fit`` at the synth-5m-warp-d64 shape.  Every path
    runs with the launch counts set to 0 just before it; returns the
    kernels line's numbers for K1 and K4."""
    from lightfm_tpu_torch import LightFM, fast_warp, train
    from lightfm_tpu_torch.ops import adagrad_update as au
    from lightfm_tpu_torch.ops import rank_counts as rc

    def counted(fn, *args, **kwargs):
        au.reset_launches()
        rc.reset_launches()
        out = fn(*args, **kwargs)
        return out, {**au.launches, **rc.launches}

    t0 = time.perf_counter()
    coo = clustered_interactions(TRAIN_USERS, TRAIN_ITEMS, TRAIN_NNZ, seed)
    csr = coo.tocsr()
    log(f"phase 5: training, {TRAIN_USERS} users x {TRAIN_ITEMS} items, {coo.nnz} interactions, "
        f"D={D}, batch {TRAIN_BATCH} (data made in {time.perf_counter() - t0:.1f} s)")

    def model(**kw):
        return LightFM(**{**dict(loss="warp", no_components=D, batch_size=TRAIN_BATCH,
                                 random_state=seed), **kw})

    # The main path, traced: epochs, shuffles, steps, K1 calls, pool
    # scatters; the arguments of epoch 2's second step are kept.
    steps_per_epoch = -(-coo.nnz // TRAIN_BATCH)
    spans = Spans(torch, capture_at=("step", steps_per_epoch + 1))
    targets = [(train, "_epoch", "epoch"), (fast_warp, "shuffle_item_sorted", "shuffle"),
               (fast_warp, "warp_pool_step", "step"), (fast_warp, "_sorted_update", "k1"),
               (fast_warp, "_scatter_update", "scatter")]
    m = model()
    check(m.device == "cuda", "LightFM() defaults to the CUDA device")
    with spans.patch(targets):
        torch.cuda.synchronize()
        _, launches = counted(m.fit, coo, epochs=TRAIN_EPOCHS)
    torch.cuda.synchronize()
    steps = m._staged_train_data.packed.shape[1] // TRAIN_BATCH
    check(steps == steps_per_epoch, f"{steps} steps per epoch")
    check(m._staged_fast == "einsum", "fit engaged the fast path")
    want = 2 * steps * TRAIN_EPOCHS
    check(launches["sorted_adagrad_update"] == want,
          f"K1 launched 2 x {steps} steps x {TRAIN_EPOCHS} epochs = {want} times in the fit")
    epochs = [r for r in spans.records if r["label"] == "epoch"]
    epoch_ms = [r["start"].elapsed_time(r["stop"]) for r in epochs]
    steady_ms = float(np.median(epoch_ms[1:]))
    log(f"  fit: {m.fit_stats_.wall_s:.3f} s wall, {m.fit_stats_.examples_per_sec:.1f} examples/s; "
        f"epoch ms (CUDA events): {json.dumps(epoch_ms)}; "
        f"host ms to enqueue each epoch: {json.dumps([r['host_ms'] for r in epochs])}")
    log(f"  steady epoch {steady_ms:.3f} ms (median of epochs 2-{TRAIN_EPOCHS}) = "
        f"{coo.nnz / (steady_ms / 1e3):.1f} examples/s")
    breakdown = step_breakdown(spans, 1)
    log("  step breakdown, epoch 2 (ms): " + json.dumps(breakdown))
    auc = auc_sample(m, csr)
    log(f"  train-sample AUC over 2,048 users after {TRAIN_EPOCHS} epochs: {auc:.4f}")
    check(auc >= AUC_FLOOR, f"train-sample AUC {auc:.4f} >= {AUC_FLOOR}")
    check(bool(torch.isfinite(m._state.item_table).all() and torch.isfinite(m._state.user_table).all()),
          "tables are finite")

    k1_calls = [r for r in spans.records if r["label"] == "k1" and r["args"] is not None]
    item_args, user_args = k1_calls[0]["args"], k1_calls[1]["args"]
    spans.records = []
    profiled_epoch(torch, train, m, seed)

    path_launches = {"fit warp x15": launches}
    runs = []
    for _ in range(2):
        (r, path_launches["fit warp x1 (determinism)"]) = counted(
            model(random_state=seed + 7).fit, coo, epochs=1
        )
        runs.append(r._state)
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          "two same-seed 1-epoch fits give bitwise-equal state")
    del runs
    for name, kw, k1_per_step in (
        ("bpr", dict(loss="bpr"), 2),
        ("logistic", dict(loss="logistic"), 2),
        ("warp user_pallas=False", dict(user_pallas=False), 1),
    ):
        r, path_launches[f"fit {name} x1"] = counted(model(**kw).fit, coo, epochs=1)
        got = path_launches[f"fit {name} x1"]["sorted_adagrad_update"]
        log(f"  {name}: 1 epoch {r.fit_stats_.wall_s:.3f} s wall (host prep included)")
        check(r._staged_fast == "einsum" and got == k1_per_step * steps,
              f"{name}: fast path, K1 launched {k1_per_step} x {steps} = {got} times")
        check(bool(torch.isfinite(r._state.item_table).all()), f"{name}: tables are finite")
    log("  kernel launches by path (each counted from 0): " + json.dumps(path_launches))

    # K1 and K4 timed on the real touches of epoch 2, step 2.
    from lightfm_tpu_torch.state import table_width

    W = table_width(D)
    rows = {}
    for side, args, table, acc in (("items", item_args, m._state.item_table, m._state.item_acc),
                                   ("users", user_args, m._state.user_table, m._state.user_acc)):
        sidx, wg = args[2].contiguous(), args[3].contiguous()
        M = sidx.shape[0]
        tw, aw = table.clone(), acc.clone()
        k_ms = time_ms(torch, lambda: au.sorted_adagrad_update(tw, aw, sidx, wg, LR, "default"), reps=20)
        p_ms = time_ms(torch, lambda: au.sorted_adagrad_update_plain(tw, aw, sidx, wg, LR, "default"), reps=10)
        tk, ak = table.clone(), acc.clone()
        au.sorted_adagrad_update(tk, ak, sidx, wg, LR, "default")
        tp, ap = table.clone(), acc.clone()
        au.sorted_adagrad_update_plain(tp, ap, sidx, wg, LR, "default")
        t_tol, a_tol = update_tolerance(torch, table, acc, sidx, wg)
        err = max(float((tk - tp).abs().max()), float((ak - ap).abs().max()))
        check(bool(((tk - tp).abs() <= t_tol).all() and ((ak - ap).abs() <= a_tol).all()),
              f"K1 on the step's {side}: kernel equals plain within the bound (max |d| {err:.3g})")
        runs_ = torch.unique_consecutive(sidx, return_counts=True)[1]
        distinct = int(runs_.numel())
        bound = (4 * M * (W + 1) + 16 * W * distinct) / HBM_BYTES_PER_S * 1e3
        rows[side] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "max_abs_err": err,
                      "distinct": distinct, "hottest": int(runs_.max()), "M": M}
        if side == "items":
            order = torch.randperm(M, device=sidx.device)
            us, ug = sidx[order].contiguous(), wg[order].contiguous()
            k4_ms = time_ms(torch, lambda: au.adagrad_update(tw, aw, us, ug, LR, "default"), reps=20)
            k4_plain = time_ms(torch, lambda: au.sorted_adagrad_update_plain(tw, aw, us, ug, LR, "default"), reps=10)
            t4, a4 = table.clone(), acc.clone()
            _, k4_launches = counted(au.adagrad_update, t4, a4, us, ug, LR, "default")
            k4_err = max(float((t4 - tp).abs().max()), float((a4 - ap).abs().max()))
            check(k4_launches["adagrad_update"] == 1 and k4_launches["sorted_adagrad_update"] == 1,
                  "one K4 call launches K1 once")
            check(bool(((t4 - tp).abs() <= t_tol).all() and ((a4 - ap).abs() <= a_tol).all()),
                  f"K4 on the step's shuffled items equals plain within the bound")
            rows["k4"] = {"ms": k4_ms, "plain_ms": k4_plain, "bound_ms": bound,
                          "launches": k4_launches["adagrad_update"], "max_abs_err": k4_err}
        del tw, aw, tk, ak, tp, ap, t_tol, a_tol
    log("  K1/K4 on the real step touches (ms, default precision): " + json.dumps(rows))
    torch.cuda.empty_cache()
    return {"launches": launches, "rows": rows}


def hybrid_step_breakdown(spans: Spans, epoch: int) -> dict:
    """Per-part CUDA-event times of the steps of one epoch of a traced
    hybrid WARP fit: forward and pool scoring (step start to K3), K3 on the
    item touches, the aggregated positive phase (transposed thin walk, the
    two fat-tier GEMMs, dense table move), the pool scatter plus the
    aggregated pool phase, and the user update (gradient permute + K1)."""
    epochs, cur = [], None
    for rec in spans.records:
        if rec["label"] == "epoch":
            cur = {"shuffle": None, "steps": []}
            epochs.append(cur)
        elif rec["label"] == "shuffle":
            cur["shuffle"] = rec
        elif rec["label"] == "step":
            cur["steps"].append([rec])
        else:
            cur["steps"][-1].append(rec)
    ep = epochs[epoch]

    def ms(a, b):
        return a.elapsed_time(b)

    parts = []
    for recs in ep["steps"]:
        step = recs[0]
        by = {}
        for r in recs[1:]:
            by.setdefault(r["label"], []).append(r)
        (k3,), (agg_p, agg_n), (k1,) = by["k3"], by["agg"], by["k1"]
        fat = [ms(r["start"], r["stop"]) for r in by["fat"]]
        parts.append({
            "forward and pool scoring": ms(step["start"], k3["start"]),
            "K3 items": ms(k3["start"], k3["stop"]),
            "aggregated positive phase": ms(agg_p["start"], agg_p["stop"]),
            "of it fat GEMMs": sum(fat[:2]),
            "pool scatter + aggregated pool phase": ms(agg_p["stop"], agg_n["stop"]),
            "of it fat GEMMs (pool)": sum(fat[2:]),
            "user update (permute + K1)": ms(agg_n["stop"], step["stop"]),
            "of it K1 users": ms(k1["start"], k1["stop"]),
            "whole step": ms(step["start"], step["stop"]),
        })
    names = list(parts[0])
    return {
        "shuffle_ms": ms(ep["shuffle"]["start"], ep["shuffle"]["stop"]),
        "steps": len(parts),
        "step_1": parts[1],
        "mean_over_steps": {n: float(np.mean([p[n] for p in parts])) for n in names},
    }


def hybrid_path(torch, seed: int) -> dict:
    """Phase 6: ``LightFM.fit(..., item_features=tags)`` at the warp-hybrid
    shape.  Every path runs with the launch counts set to 0 just before it;
    returns the kernels line's numbers for K3."""
    from lightfm_tpu_torch import LightFM, fast_warp, train
    from lightfm_tpu_torch.ops import grad_sums as gs

    t0 = time.perf_counter()
    coo = clustered_interactions(TRAIN_USERS, TRAIN_ITEMS, TRAIN_NNZ, seed)
    csr = coo.tocsr()
    feats = tag_features(TRAIN_ITEMS)
    log(f"phase 6: hybrid training, {TRAIN_USERS} users x {TRAIN_ITEMS} items, {coo.nnz} "
        f"interactions, item features {feats.shape[0]} x {feats.shape[1]} "
        f"({feats.nnz / feats.shape[0]:.2f} per row), D={D}, batch {TRAIN_BATCH} "
        f"(data made in {time.perf_counter() - t0:.1f} s)")

    def model(**kw):
        return LightFM(**{**dict(loss="warp", no_components=D, batch_size=TRAIN_BATCH,
                                 random_state=seed), **kw})

    steps_per_epoch = -(-coo.nnz // TRAIN_BATCH)
    spans = Spans(torch, capture_at=("step", steps_per_epoch + 1))
    targets = [(train, "_epoch", "epoch"), (fast_warp, "shuffle_item_sorted", "shuffle"),
               (fast_warp, "warp_pool_step", "step"), (fast_warp, "sorted_grad_sums", "k3"),
               (fast_warp, "_aggregated_feature_update", "agg"),
               (fast_warp, "_fat_product", "fat"), (fast_warp, "_sorted_update", "k1")]
    m = model()
    with spans.patch(targets):
        torch.cuda.synchronize()
        _, launches = counted_all(m.fit, coo, epochs=HYBRID_EPOCHS, item_features=feats)
    torch.cuda.synchronize()
    data = m._staged_train_data
    steps = data.packed.shape[1] // TRAIN_BATCH
    check(m._staged_fast == "einsum", "the hybrid fit engaged the fast path")
    check(data.item_feats_T is not None and data.item_feats_T.fat_rows is not None,
          f"item_feats_T staged with a fat tier of {data.item_feats_T.fat_rows.numel()} rows "
          f"({data.item_feats_T.fat_w.dtype}, fat_w2 shared: "
          f"{data.item_feats_T.fat_w2 is data.item_feats_T.fat_w})")
    want = steps * HYBRID_EPOCHS
    check(launches["sorted_grad_sums"] == want,
          f"K3 launched {steps} steps x {HYBRID_EPOCHS} epochs = {want} times in the fit")
    check(launches["sorted_adagrad_update"] == want, f"K1 (identity users) launched {want} times")
    epochs = [r for r in spans.records if r["label"] == "epoch"]
    epoch_ms = [r["start"].elapsed_time(r["stop"]) for r in epochs]
    steady_ms = float(np.median(epoch_ms[1:]))
    log(f"  hybrid fit: {m.fit_stats_.wall_s:.3f} s wall (staging and the transposed build "
        f"included), epoch ms (CUDA events): {json.dumps(epoch_ms)}; host ms to enqueue each "
        f"epoch: {json.dumps([r['host_ms'] for r in epochs])}")
    log(f"  steady hybrid epoch {steady_ms:.3f} ms (median of epochs 2-{HYBRID_EPOCHS}) = "
        f"{coo.nnz / (steady_ms / 1e3):.1f} examples/s")
    log("  hybrid step breakdown, epoch 2 (ms): " + json.dumps(hybrid_step_breakdown(spans, 1)))
    auc, guard_launches = counted_all(auc_sample, m, csr, item_features=feats)
    log(f"  hybrid train-sample AUC over 2,048 users after {HYBRID_EPOCHS} epochs: {auc:.4f}")
    check(auc >= HYBRID_AUC_FLOOR, f"hybrid train-sample AUC {auc:.4f} >= {HYBRID_AUC_FLOOR}")
    # The sampled users' rows hold more than COUNT_T_LIMIT = 32 positives, so
    # the guard's predict_rank takes the blocked matmul path, not the rank
    # kernels (the JAX package's dispatch, ops/ranking.py).  Serving the
    # hybrid model through K2: one positive per sampled user held out (T = 1),
    # its other positives excluded, ranked through the item features.
    binary = (csr != 0).astype(np.float32)
    eligible = np.flatnonzero(np.diff(binary.indptr) >= 2)
    users = np.random.RandomState(seed + 5).choice(eligible, min(4096, eligible.size), replace=False)
    held = binary.indices[binary.indptr[users]]
    test = sp.csr_matrix((np.ones(users.size, np.float32), (users, held)), shape=binary.shape)
    rest = (binary - test).tocsr()
    rest.eliminate_zeros()
    ranks, serve_launches = counted_all(m.predict_rank, test, train_interactions=rest,
                                        item_features=feats, check_intersections=False)
    check(serve_launches["rank_counts"] > 0 and serve_launches["pair_scores"] > 0,
          "predict_rank with item features went through both rank kernels")
    item_reps = np.asarray(feats.dot(m._state.item_table.cpu().numpy()))
    # The trained catalog's scores lie dense (median gap near the 1e-5 *
    # max|score| tie band), so many ranks are near ties; the bands stay narrow.
    n_exact, n_near, widest = check_ranks_float64(
        ranks, test, rest, m._state.user_table.cpu().numpy(), item_reps, users[:256])
    check(widest <= TRAIN_ITEMS // 100,
          f"256 users' hybrid ranks equal float64 numpy ({n_exact} exact, {n_near} near ties "
          f"in bounds, widest band {widest} ranks)")
    del item_reps
    check(bool(torch.isfinite(m._state.item_table).all()
               and torch.isfinite(m._state.user_table).all()), "hybrid tables are finite")
    k3_args = [r["args"] for r in spans.records if r["label"] == "k3" and r["args"] is not None][0]
    spans.records = []
    profiled_epoch(torch, train, m, seed)

    path_launches = {f"fit warp-hybrid x{HYBRID_EPOCHS}": launches,
                     "auc guard (predict_rank, item features)": guard_launches,
                     "predict_rank T=1 (item features)": serve_launches}
    runs = []
    for _ in range(2):
        r, path_launches["fit warp-hybrid x1 (determinism)"] = counted_all(
            model(random_state=seed + 7).fit, coo, epochs=1, item_features=feats
        )
        runs.append(r._state)
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          "two same-seed 1-epoch hybrid fits give bitwise-equal state")
    del runs
    r, path_launches["fit bpr-hybrid x1"] = counted_all(
        model(loss="bpr").fit, coo, epochs=1, item_features=feats
    )
    log(f"  bpr-hybrid: 1 epoch {r.fit_stats_.wall_s:.3f} s wall (host prep included)")
    check(r._staged_fast == "einsum" and path_launches["fit bpr-hybrid x1"]["sorted_grad_sums"] == steps,
          f"bpr-hybrid: fast path, K3 launched {steps} times")
    check(bool(torch.isfinite(r._state.item_table).all()), "bpr-hybrid: tables are finite")
    del r
    log("  kernel launches by path (each counted from 0): " + json.dumps(path_launches))

    # K3 on the real item touches of epoch 2, step 2.
    sidx, wg, n_rows, _ = k3_args
    sidx, wg = sidx.contiguous(), wg.contiguous()
    M, W = wg.shape
    err = check_grad_sums(torch, gs, sidx, wg, n_rows, "on the step's item touches")
    k_ms = time_ms(torch, lambda: gs.sorted_grad_sums(sidx, wg, n_rows, "default"), reps=20)
    p_ms = time_ms(torch, lambda: gs.sorted_grad_sums_plain(sidx, wg, n_rows, "default"), reps=10)
    both = torch.cat([wg, wg * wg], dim=1)
    rows = sidx.long()

    def library():
        torch.zeros((n_rows, 2 * W), dtype=torch.float32, device=wg.device).index_add_(0, rows, both)

    lib_ms = time_ms(torch, library, reps=20)
    bound = (4 * M * (W + 1) + 8 * W * n_rows) / HBM_BYTES_PER_S * 1e3
    runs_ = torch.unique_consecutive(sidx, return_counts=True)[1]
    row = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": bound,
           "max_abs_err": err, "M": M, "W": W, "n_rows": n_rows,
           "distinct": int(runs_.numel()), "hottest": int(runs_.max())}
    log("  K3 on the real step touches (ms, default precision): " + json.dumps(row))
    del m, data
    torch.cuda.empty_cache()
    return {"launches": launches, "row": row}


def planted_ml100k(seed: int):
    """A planted implicit set of the synthetic MovieLens 100k's size, after
    ``lightfm_tpu/datasets/synthetic.py:64-107``: rank-8 factors, a Zipf
    popularity prior, lognormal user degrees (mean ~106, clipped at 20 and
    737), items chosen by Gumbel top-k, ratings by within-user quantile
    through ML-100k's histogram; kept: the rating-5 cells (~19k)."""
    rng = np.random.RandomState(seed)
    U = rng.randn(FIT_USERS, 8).astype(np.float32) / np.sqrt(8)
    V = rng.randn(FIT_ITEMS, 8).astype(np.float32) / np.sqrt(8)
    pop = 1.0 / np.arange(1, FIT_ITEMS + 1) ** 0.8
    rng.shuffle(pop)
    counts = np.clip(rng.lognormal(np.log(0.61 * 106), 0.95, FIT_USERS), 20, 737).astype(np.int64)
    scores = U @ V.T
    keys = 4.5 * scores + np.log(pop)[None, :] + rng.gumbel(size=scores.shape)
    order = np.argsort(-keys, axis=1)
    rows, cols = [], []
    for u in range(FIT_USERS):
        chosen = order[u, : counts[u]]
        q = (np.argsort(np.argsort(scores[u, chosen])) + 0.5) / len(chosen)
        five = chosen[q >= 0.7880]  # the top 21.2%: rating 5
        rows.append(np.full(len(five), u))
        cols.append(five)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                         shape=(FIT_USERS, FIT_ITEMS))


def fit_quality(ut, it, train):
    """Train AUC and precision@5 of a state over every user's positives
    (numpy, from the tables' embeddings and biases)."""
    u, v = ut.detach().cpu().numpy().astype(np.float64), it.detach().cpu().numpy().astype(np.float64)
    scores = u[:, :-1] @ v[:, :-1].T + u[:, -1:] + v[None, :, -1]
    aucs, p5 = [], []
    for uu in range(train.shape[0]):
        pos = train.indices[train.indptr[uu]: train.indptr[uu + 1]]
        if not len(pos):
            continue
        s = scores[uu]
        mask = np.ones(train.shape[1], bool)
        mask[pos] = False
        aucs.append((s[pos][:, None] > s[mask][None, :]).mean())
        p5.append(np.isin(np.argsort(-s)[:5], pos).mean())
    return float(np.mean(aucs)), float(np.mean(p5))


def warp_fit_path(torch, seed: int) -> dict:
    """Phase 7: the whole-fit WARP kernel (K5) at the quickstart's size:
    against its plain version after a few steps, then a whole 30-epoch fit
    in one launch, held to the plain version's quality."""
    from lightfm_tpu_torch.ops import warp_fit as wf
    from lightfm_tpu_torch.sparse import pad_csr_sorted
    from lightfm_tpu_torch.state import init_state
    from lightfm_tpu_torch.train import choose_batch_size

    dev = torch.device(DEVICE)
    train = planted_ml100k(seed)
    coo = train.tocoo()
    n = coo.nnz
    B = choose_batch_size(n, None)
    n_pad = -(-n // B) * B
    packed = np.zeros((8, n_pad), np.int32)
    packed[0, :n], packed[1, :n] = coo.row, coo.col
    packed[2, :n] = packed[3, :n] = np.float32(1.0).view(np.int32)
    packed[4, :n] = 1
    rng = np.random.RandomState(seed + 9)
    batches = np.concatenate([
        packed[:, rng.permutation(n_pad)].reshape(8, n_pad // B, B).transpose(1, 0, 2)
        for _ in range(FIT_EPOCHS)
    ])
    S = batches.shape[0]
    negs = rng.randint(0, FIT_ITEMS, (S, 1, FIT_K * B)).astype(np.int32)
    positives = pad_csr_sorted(train, pad_multiple=8, device=dev).idx
    state = init_state(FIT_D, FIT_ITEMS, FIT_USERS, np.random.RandomState(seed), adagrad=True,
                       device=dev)
    tables = (state.user_table, state.user_acc, state.item_table, state.item_acc)
    batches_t = torch.from_numpy(np.ascontiguousarray(batches)).to(dev)
    negs_t = torch.from_numpy(negs).to(dev)
    kw = dict(n_items=FIT_ITEMS, max_sampled=FIT_K, learning_rate=LR)
    W = tables[0].shape[1]
    log(f"phase 7: whole-fit WARP kernel (K5), {FIT_USERS} users x {FIT_ITEMS} items, "
        f"{n} positives, D={FIT_D} (W={W}), B={B}, K={FIT_K}, {FIT_EPOCHS} epochs = {S} steps, "
        f"positives width {positives.shape[1]}")

    names = ("user_table", "user_acc", "item_table", "item_acc")
    few = 4
    got = wf.warp_fit_fused(*tables, batches_t[:few], negs_t[:few], positives, **kw)
    want = wf.warp_fit_fused_plain(*tables, batches_t[:few], negs_t[:few], positives, **kw)
    err = 0.0
    for name, g, w in zip(names, got, want):
        d = (g - w).abs()
        err = max(err, float(d.max()))
        check(bool((d <= 1e-5 + 1e-5 * w.abs()).all()),
              f"K5 after {few} steps: {name} equals plain to 1e-5 + 1e-5|x| (max |d| {float(d.max()):.3g})")

    (k_state, launches) = counted_all(wf.warp_fit_fused, *tables, batches_t, negs_t, positives, **kw)
    check(launches["warp_fit_fused"] == 1, f"the whole {S}-step fit is one K5 launch")
    again = wf.warp_fit_fused(*tables, batches_t, negs_t, positives, **kw)
    check(all(torch.equal(a, b) for a, b in zip(k_state, again)), "two K5 fits are bitwise equal")
    p_state = wf.warp_fit_fused_plain(*tables, batches_t, negs_t, positives, **kw)
    k_auc, k_p5 = fit_quality(k_state[0], k_state[2], train)
    p_auc, p_p5 = fit_quality(p_state[0], p_state[2], train)
    i_auc, _ = fit_quality(tables[0], tables[2], train)
    log(f"  train AUC / p@5 after {FIT_EPOCHS} epochs: kernel {k_auc:.4f} / {k_p5:.4f}, "
        f"plain {p_auc:.4f} / {p_p5:.4f} (initial AUC {i_auc:.4f})")
    check(all(bool(torch.isfinite(x).all()) for x in k_state)
          and bool((k_state[1] >= 1).all() and (k_state[3] >= 1).all()),
          "K5 state is finite and every accumulator >= 1")
    check(abs(k_auc - p_auc) <= 0.01 and abs(k_p5 - p_p5) <= 0.03,
          "K5 fit quality within 0.01 AUC and 0.03 p@5 of the plain version's")
    check(k_auc >= i_auc + 0.1, "the K5 fit learned (AUC up by >= 0.1)")

    k_ms = time_ms(torch, lambda: wf.warp_fit_fused(*tables, batches_t, negs_t, positives, **kw),
                   reps=3)
    p_ms = time_ms(torch, lambda: wf.warp_fit_fused_plain(*tables, batches_t, negs_t, positives,
                                                          **kw), reps=2)
    U, I, P = FIT_USERS, FIT_ITEMS, positives.shape[1]
    n_bytes = 4 * (2 * 2 * (U + I) * W + S * 8 * B + S * FIT_K * B + U * P)
    # Every candidate scored: the most the early-ending scan could need, and
    # still under the bytes, so the bound is the bytes whatever the data.  The
    # S steps are sequential (each reads the tables the last one wrote); the
    # bound does not charge that chain.
    n_ops = S * B * (FIT_K + 1) * 2 * W
    peak = fp32_peak_flops(torch)
    bound = max(n_bytes / HBM_BYTES_PER_S, n_ops / peak) * 1e3
    row = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
           "bound_by": "operations" if n_ops / peak > n_bytes / HBM_BYTES_PER_S else "bytes",
           "max_abs_err": err, "launches": launches["warp_fit_fused"], "steps": S,
           "ms_per_step": k_ms / S}
    log("  K5 whole fit (ms): " + json.dumps(row))
    return row


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from lightfm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    log(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s")
    for name in ("rank_counts", "adagrad_update", "grad_sums", "warp_fit"):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}:", line.strip())
    card = nvidia_smi("name,power.limit")

    i_pad = -(-(N_ITEMS + 1) // 2048) * 2048  # the ranking path's padded catalog
    kernels = kernel_checks(torch, args.seed, i_pad)
    launches = serving_path(torch, args.seed)
    for rec in kernels:
        rec["launches"] = launches[rec["name"]]
        check(rec["launches"] > 0, f"{rec['name']} launched on the serving path")

    zipf_err = update_kernel_checks(torch, args.seed)
    k3_zipf_err = grad_sums_checks(torch, args.seed)
    trained = training_path(torch, args.seed)
    hybrid = hybrid_path(torch, args.seed)
    k5 = warp_fit_path(torch, args.seed)
    items, k4 = trained["rows"]["items"], trained["rows"]["k4"]
    k1_launches = trained["launches"]["sorted_adagrad_update"]
    check(k1_launches > 0, "sorted_adagrad_update launched on the training path")
    kernels += [
        {
            "name": "sorted_adagrad_update", "route": "cuda",
            "source": "lightfm_tpu_torch/csrc/adagrad_update.cu",
            "replaces": "lightfm_tpu/ops/pallas_update.py:234",
            "launches": k1_launches,
            "max_abs_err": max(zipf_err, items["max_abs_err"], trained["rows"]["users"]["max_abs_err"]),
            "ms": items["ms"], "plain_ms": items["plain_ms"], "bound_ms": items["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
        },
        {
            "name": "adagrad_update", "route": "cuda",
            "source": "lightfm_tpu_torch/csrc/adagrad_update.cu",
            "replaces": "lightfm_tpu/ops/pallas_update.py:139",
            "launches": k4["launches"], "max_abs_err": k4["max_abs_err"],
            "ms": k4["ms"], "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
        },
    ]
    k3 = hybrid["row"]
    check(hybrid["launches"]["sorted_grad_sums"] > 0, "sorted_grad_sums launched on the hybrid path")
    check(k5["launches"] > 0, "warp_fit_fused launched on the whole-fit path")
    kernels += [
        {
            "name": "sorted_grad_sums", "route": "cuda",
            "source": "lightfm_tpu_torch/csrc/grad_sums.cu",
            "replaces": "lightfm_tpu/ops/pallas_update.py:365",
            "launches": hybrid["launches"]["sorted_grad_sums"],
            "max_abs_err": max(k3_zipf_err, k3["max_abs_err"]),
            "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
            "bound_by": "bytes", "library_ms": k3["library_ms"],
        },
        {
            "name": "warp_fit_fused", "route": "cuda",
            "source": "lightfm_tpu_torch/csrc/warp_fit.cu",
            "replaces": "lightfm_tpu/ops/pallas_train.py:174",
            "launches": k5["launches"], "max_abs_err": k5["max_abs_err"],
            "ms": k5["ms"], "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
            "bound_by": k5["bound_by"], "library_ms": None,
        },
    ]

    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
