"""Smoke run of lightfm_tpu_torch's serving path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the CUDA kernels from ``lightfm_tpu_torch/csrc`` (into the ignored
``lightfm_tpu_torch/_build``), holds each kernel against its plain PyTorch
version at the serving shape of ``benchmarks/bench_serving.py`` (50,000
users x 100,000 items, D=64, T=10), then drives ``LightFM.predict_rank``
with the four metrics, ``recommend`` and ``predict`` at that width with
random weights made from ``--seed``, and checks what comes out.  Any failed
check raises, so the exit code is non-zero; the last stdout line is the
device record, the line before it the per-kernel record.

Needs a CUDA device: without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp

N_USERS, N_ITEMS, D, T_TEST, N_TRAIN = 50_000, 100_000, 64, 10, 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)


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
    catalog score lies within 1e-5 * max|score| of the test score."""
    u = user_table[users].astype(np.float64)
    it = item_table.astype(np.float64)
    scores = u[:, :-1] @ it[:, :-1].T + u[:, -1:] + it[None, :, -1]
    n_exact = n_near = 0
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
    return n_exact, n_near


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
    n_exact, n_near = check_ranks_float64(
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
    for line in _build.build_log("rank_counts").splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())
    card = nvidia_smi("name,power.limit")

    i_pad = -(-(N_ITEMS + 1) // 2048) * 2048  # the ranking path's padded catalog
    kernels = kernel_checks(torch, args.seed, i_pad)
    launches = serving_path(torch, args.seed)
    for rec in kernels:
        rec["launches"] = launches[rec["name"]]
        check(rec["launches"] > 0, f"{rec['name']} launched on the serving path")

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
