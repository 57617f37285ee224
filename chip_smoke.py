"""Smoke run of lightfm_tpu_torch's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the CUDA kernels from ``lightfm_tpu_torch/csrc`` (into the ignored
``lightfm_tpu_torch/_build``), holds each rank kernel against its plain
PyTorch version at the serving shape of ``benchmarks/bench_serving.py``
(50,000 users x 100,000 items, D=64, T=10), at the heavy-tier and hybrid
launch shapes and at the launch plan's edges, then drives
``LightFM.predict_rank`` with the four metrics, ``recommend`` and
``predict`` at that width with random weights made from ``--seed``, and
checks what comes out, with one ``predict_rank`` at D=712 (rows so wide
that the rank kernel streams its user tile).  Then it holds the
adagrad update kernel (K1, and K4 over it) against its plain version on
Zipf, uniform and hot-row touches at the training step's shape and on
touches laid out against the kernel's segments at four widths, with
CUDA-event, profiler and host times for each, the gradient-sums kernel
(K3) on the same touch layouts, the generic step's adagrad kernel
(``touch_adagrad_update``, phase 4c) at the ``warp-hybrid-l2`` cell's item
and user touches, whole and split as the table partitions split them, with
one epoch of a generic hybrid fit through it, and trains with ``LightFM.fit`` at the
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
x 1,682 items, D=10) in one launch, against its plain version.  Phase 8
drives the generic training path (PyTorch, with its adagrad pass through
``touch_adagrad_update`` and no other hand-written kernel):
the quickstart's 30-epoch WARP fit at that size with ``fast_path="auto"``
(quality against the port's own CPU fit), one epoch of every loss and
schedule (and L2) on the card against the CPU with the same draws and
bitwise against a repeat, hybrid logistic and chunked feature rows, two
epochs at the ``synth-5m-warp-d64`` shape with ``fast_path="off"`` beside
phase 5's fast epoch, and a mid-fit checkpoint resumed bit-exactly.  Phase 9
drives the host side from raw data: phase 6's interactions and tags as a
log of scrambled int64 external ids go through ``Dataset`` on the port's
native ingest engine (its matrices, mapped back, equal phase 6's entry for
entry; the log's first 500,000 rows also through the pure-Python path),
``random_train_test_split`` (80/20), the hybrid fit on the train split
through K1 and K3, and ``auc_score`` / ``precision_at_k`` on a 2,048-user
sample of the test split through the rank kernels, with one more epoch
under ``observability.trace``.  Phase 10 drives multi-device training
over ``torch.distributed`` in child processes of this script (the main
process never holds a process group): (a) one NCCL rank fits the
``synth-5m-warp-d64`` shape on the data-parallel fast path through K1,
bitwise the fit without a mesh, and serves ``recommend`` through
``top_k_sharded``; (b) two gloo ranks sharing the card fit 3 epochs there
with bitwise-equal replicas, one step within the CPU tests' bound of the
one-device step and the train-sample AUC within 0.005 of the one-device
fit's, then at the quickstart size one generic epoch against one device,
an example-sharded fit with the local shuffle and ``recommend`` over a
(1, 2) mesh.  Phase 11 splits the tables over the model axis, again in
child processes: two gloo ranks on a (1, 2) mesh train one generic epoch
at the ``synth-5m-warp-d64`` widths (depth cut to 4 steps) with the tables
split (a) by rows and (b) by components, each rank holding half of each
table; the assembled state is held against the one-device fit of the same
data and seed; ``predict_rank`` (through K2 and ``pair_scores``, the users'
rows read by id over the model axis and the item table assembled),
``recommend`` (each rank scoring its own item rows under rows) and
``predict`` (the pairs' rows) run on the split model, each from a cold
serving cache with its peak bytes, bytes sent and the tables it asked to
assemble (never the user table), and are held against the one-device
model's and the replicated-table model's on the same mesh; then
(c) four gloo ranks on a (2, 2) mesh train the quickstart size by rows with
example-sharded input and the local shuffle, checkpointing every 10
epochs, and the last checkpoint loads in this process as the assembled
state.  Gloo shows correctness only: it moves every collective through the
host.  Phases 10 and 11 put each child rank on its own card where the
machine has enough, else on cuda:0.  Phase 12 runs where the machine has
two cards or more (on one it logs that it needs two): one NCCL rank a
card, n = 2 or 4, (a) the data-parallel 5M fit of 2 epochs through K1,
bitwise the same fit under gloo on the same cards, with ``recommend``
through ``top_k_sharded``; (b) rows and (c) components on (1, n) as phase
11's (a) and (b), through K2 and ``pair_scores``; (d) at n = 4 phase 11's
(c), its checkpoint loaded into a one-device model bitwise; each rank
times its collectives with CUDA events, and the phase logs the cards'
topology and the compute processes on each card.  Any failed check raises,
so the exit code is non-zero;
the last stdout line is the device record, the line before it the
per-kernel record.

Needs a CUDA device: without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
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
    # path, the T=1 and T=32 templates, the user tile streamed at Wa = 300
    # and 721 with a part-filled last user tile), integer-valued so exact.
    for wa, t in ((265, 32), (9, 1), (40, 17), (300, 32), (721, 10)):
        su = randint(-2, 3, (1001, wa)).float()
        si = randint(-2, 3, (5000, wa)).float()
        sts = rc.pair_scores(su, si, randint(0, 5000, (1001, t)).int())
        same = torch.equal(rc.rank_counts(su, si, sts), rc.rank_counts_plain(su, si, sts))
        check(same, f"Wa={wa}, T={t}: rank_counts equals plain exactly")

    # (e) the shapes of the main path's other launches and the edges of the
    # launch plan, integer-valued so exact: the heavy tier (U=256), the
    # hybrid predict_rank (U=4,096, T=1), one user and one item, and a
    # catalog of one tile plus one row.
    def plan_text(n_u, n_i, t, wa):
        shape, plan = rc.plan_for(n_u, n_i, t, wa, dev)
        return (f"{shape.block_users} users x {rc.BLOCK_ITEMS} items a block, t_pad "
                f"{shape.t_pad}, {shape.smem_bytes} B smem, {shape.blocks_per_sm}/SM; "
                f"grid {plan.user_tiles} x {plan.item_splits} = {plan.blocks} blocks, "
                f"{plan.tiles_per_split} tiles a split")

    log(f"  plan U={U} I={I} T={T}: {plan_text(U, I, T, Wa)}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    check(rc.plan_for(256, I, T, Wa, dev)[1].blocks >= sms,
          f"the heavy tier's launch (U=256) has at least {sms} blocks, one per SM")
    for n_u, n_i, t in ((256, I, T), (4096, I, 1), (1, 1, 1), (1, 1, T), (300, 65, T)):
        su = randint(-2, 3, (n_u, Wa)).float()
        si = randint(-2, 3, (n_i, Wa)).float()
        sts = randint(-40, 41, (n_u, t)).float() / 2
        half = (t + 1) // 2
        sts[:, :half] = rc.pair_scores(su, si, randint(0, n_i, (n_u, half)).int())
        same = torch.equal(rc.rank_counts(su, si, sts), rc.rank_counts_plain(su, si, sts))
        check(same, f"U={n_u} I={n_i} T={t} [{plan_text(n_u, n_i, t, Wa)}]: "
                    "rank_counts equals plain exactly")

    # (f) two launches at the serving shape are bitwise equal (the item
    # splits add their partial counts with integer atomics); the gaussian
    # inputs of (b).
    check(torch.equal(got, rc.rank_counts(u, items, ts)),
          "two gaussian rank_counts launches are bitwise equal")

    # (g) the kernel keeps row_dot's FMA chain: for 64 users, pair_scores
    # against every catalog row (row_dot's own chain), counted with >=
    # against the same thresholds, equals the kernel's counts exactly.
    sample = torch.randperm(U, generator=g, device=dev)[:64]
    every = torch.arange(I, dtype=torch.int32, device=dev).expand(64, I).contiguous()
    s_all = rc.pair_scores(u[sample].contiguous(), items, every)
    chain = (s_all[:, None, :] >= ts[sample][:, :, None]).sum(-1).float()
    bad = int((got[sample] != chain).sum())
    log(f"  gaussian counts vs pair_scores over the whole catalog, 64 users: {bad} differ")
    check(bad == 0, "gaussian rank_counts equals >= counts over pair_scores exactly")
    del s_all, every, chain

    # Times on the gaussian inputs.
    peak = fp32_peak_flops(torch)
    uh, th = u[:256].contiguous(), ts[:256].contiguous()
    heavy_ms = time_ms(torch, lambda: rc.rank_counts(uh, items, th), reps=20)
    heavy_ops = 2 * 256 * I * Wa + 256 * I * T
    heavy_bytes = 4 * (256 * Wa + I * Wa + 2 * 256 * T)
    heavy_bound = max(heavy_bytes / HBM_BYTES_PER_S, heavy_ops / peak) * 1e3
    log(f"  rank_counts heavy tier (U=256, T={T}) {heavy_ms:.4f} ms, bound {heavy_bound:.4f} ms")
    # The compares' share: the same scores counted against 1, 4, 8 and 12
    # slots (T=1 is the FMA loop with almost no compares).
    sweep = {}
    for t in (1, 4, 8, 12):
        ts_t = torch.cat([ts, ts[:, :2]], 1)[:, :t].contiguous()
        sweep[t] = time_ms(torch, lambda: rc.rank_counts(u, items, ts_t))
    log("  rank_counts by slot count (ms): " + json.dumps(sweep))
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

    # (i) pair_scores at the shapes of its four launches in a predict_rank:
    # the test slots (C = T) and the train exclusion chunk (C = 32) of the
    # light tier, and the heavy tier's exclusion chunk (U = 256, C = 416);
    # integer-valued so exact, then times on the gaussian inputs of (b):
    # CUDA events, torch.profiler's device time, the wrapper's host enqueue,
    # and the two-call yardstick (a gather of item rows, then a row dot;
    # not bitwise, a time only).
    int_items = randint(-2, 3, (I, Wa)).float()
    ps_shapes = {}
    for what, n_u, c in (("serving", U, T), ("exclusion", U, 32), ("heavy exclusion", 256, 416)):
        iu = randint(-2, 3, (n_u, Wa)).float()
        ix = randint(0, I, (n_u, c)).int()
        check(torch.equal(rc.pair_scores(iu, int_items, ix), rc.pair_scores_plain(iu, int_items, ix)),
              f"pair_scores {what} (U={n_u}, C={c}, {rc.pair_plan(n_u, c, Wa)}): integer-valued "
              "equals plain exactly")
        gu = u[:n_u].contiguous()
        gx = idx if c == T else randint(0, I, (n_u, c)).int()

        def run(gu=gu, gx=gx):
            return rc.pair_scores(gu, items, gx)

        def two_calls(gu=gu, gx=gx):
            return (gu[:, None, :] * items[gx.long()]).sum(-1)

        rows = int(torch.unique(gx).numel())
        nbytes = 4 * (n_u * Wa + rows * Wa + 2 * n_u * c)
        ops = 2 * n_u * c * Wa
        ps_shapes[what] = {
            "U": n_u, "C": c, "ms": time_ms(torch, run, reps=50),
            "device_ms": sum(device_ms(torch, run, reps=20).values()),
            "host_ms": host_ms(torch, run, reps=50),
            "yardstick_ms": time_ms(torch, two_calls, reps=5),
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / peak) * 1e3,
            "bound_by": "operations" if ops / peak > nbytes / HBM_BYTES_PER_S else "bytes",
        }
        log(f"  pair_scores {what}: " + json.dumps(ps_shapes[what]))
    serve = ps_shapes["serving"]
    ps_p_ms = time_ms(torch, lambda: rc.pair_scores_plain(u, items, idx))
    log(f"  pair_scores plain {ps_p_ms:.4f} ms at the serving shape")
    del zu, zi, u, items, int_items
    torch.cuda.empty_cache()
    wide = wide_kernel_checks(torch, g, I, peak)

    return [
        {
            "name": "rank_counts", "route": "cuda",
            "source": "lightfm_tpu_torch/csrc/rank_counts.cu",
            "replaces": "lightfm_tpu/ops/pallas_rank.py:63",
            "launches": 0, "max_abs_err": rc_err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": rc_bound,
            "bound_by": "operations" if rc_ops / peak > rc_bytes / HBM_BYTES_PER_S else "bytes",
            "library_ms": lib_ms,
            "ms_heavy_tier": heavy_ms, "bound_ms_heavy_tier": heavy_bound,
            **wide,
        },
        {
            "name": "pair_scores", "route": "cuda",
            "source": "lightfm_tpu_torch/csrc/rank_counts.cu",
            "replaces": "lightfm_tpu/ops/ranking.py:293",
            "launches": 0, "max_abs_err": ps_err,
            "ms": serve["ms"], "plain_ms": ps_p_ms, "bound_ms": serve["bound_ms"],
            "bound_by": serve["bound_by"], "library_ms": None,
            "device_ms": serve["device_ms"], "host_ms": serve["host_ms"],
            "yardstick_ms": serve["yardstick_ms"],
            "shapes": {k: v for k, v in ps_shapes.items() if k != "serving"},
        },
    ]


WIDE_D, WIDE_USERS = 712, 1024


def wide_kernel_checks(torch, g, I: int, peak: float) -> dict:
    """Phase 2 (h): the rank kernels at the width of D = 712 (Wa = 721,
    the user tile staged chunk by chunk) on the shape of the D = 712
    ``predict_rank`` (1,024 users against the padded catalog, T = 10):
    integer-valued inputs equal plain exactly, gaussian counts equal >=
    counts over ``pair_scores`` against the whole catalog for 64 users (the
    FMA chain kept across the streamed chunks), and times."""
    from lightfm_tpu_torch.ops import rank_counts as rc
    from lightfm_tpu_torch.state import table_width

    dev = torch.device("cuda")
    U, Wa, T = WIDE_USERS, table_width(WIDE_D) + 1, T_TEST
    shape, plan = rc.plan_for(U, I, T, Wa, dev)
    log(f"  D={WIDE_D} (Wa={Wa}): {shape}, {plan}")
    check(shape.stream_users, f"Wa={Wa}: the user tile streams")

    def randint(lo, hi, shp):
        return torch.randint(lo, hi, shp, generator=g, device=dev)

    u = randint(-2, 3, (U, Wa)).float()
    items = randint(-2, 3, (I, Wa)).float()
    ts = randint(-80, 81, (U, T)).float() / 2
    ts[:, : T // 2] = rc.pair_scores(u, items, randint(0, I, (U, T // 2)).int())
    check(torch.equal(rc.rank_counts(u, items, ts), rc.rank_counts_plain(u, items, ts)),
          f"Wa={Wa}, U={U}, I={I}, T={T}: integer rank_counts equals plain exactly")

    u = torch.randn((U, Wa), generator=g, device=dev) / Wa**0.5
    items = torch.randn((I, Wa), generator=g, device=dev)
    ts = rc.pair_scores(u, items, randint(0, I, (U, T)).int())
    got = rc.rank_counts(u, items, ts)
    check(torch.equal(got, rc.rank_counts(u, items, ts)),
          f"Wa={Wa}: two gaussian rank_counts launches are bitwise equal")
    # The plain version sums in cuBLAS's order, so near ties may flip; the
    # exact check is the one against pair_scores below.  Logged only.
    want = rc.rank_counts_plain(u, items, ts)
    err = float((got - want).abs().max())
    frac = float(((got - want).abs() > 0).float().mean())
    log(f"  Wa={Wa} gaussian rank_counts vs plain (cuBLAS order): max|d|={err} "
        f"frac differing={frac:.3g}")
    every = torch.arange(I, dtype=torch.int32, device=dev).expand(64, I).contiguous()
    s_all = rc.pair_scores(u[:64].contiguous(), items, every)
    chain = (s_all[:, None, :] >= ts[:64, :, None]).sum(-1).float()
    bad = int((got[:64] != chain).sum())
    check(bad == 0, f"Wa={Wa}: gaussian rank_counts equals >= counts over pair_scores "
                    f"exactly (64 users x {I} items; {bad} differ)")
    del every, s_all, chain

    def scores_matmul():
        s = u @ items.T
        del s

    k_ms = time_ms(torch, lambda: rc.rank_counts(u, items, ts), reps=10)
    p_ms = time_ms(torch, lambda: rc.rank_counts_plain(u, items, ts), reps=3)
    lib_ms = time_ms(torch, scores_matmul, reps=5)
    ops = 2 * U * I * Wa + U * I * T
    nbytes = 4 * (U * Wa + I * Wa + 2 * U * T)
    bound = max(nbytes / HBM_BYTES_PER_S, ops / peak) * 1e3
    log(f"  rank_counts Wa={Wa} U={U}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
        f"matmul {lib_ms:.4f} ms, bound {bound:.4f} ms")
    del u, items, ts, got, want
    torch.cuda.empty_cache()
    return {"ms_wide": k_ms, "plain_ms_wide": p_ms, "library_ms_wide": lib_ms,
            "bound_ms_wide": bound, "max_abs_err_wide": err}


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


def wide_rank_check(torch, seed: int) -> dict:
    """``predict_rank`` at D = 712 for 1,024 users against the serving
    catalog, through the rank kernels (Wa = 721: the user tile streams).
    Random weights with 1,024 planted clusters (about 98 items each), 10
    test and 20 train items per user inside its cluster, so most test
    scores lie where few catalog scores do and most ranks are exact against
    float64 numpy (64 users held).  Returns the call's launch counts."""
    from lightfm_tpu_torch import LightFM, interop
    from lightfm_tpu_torch.ops import rank_counts as rc
    from lightfm_tpu_torch.state import table_width

    rng = np.random.RandomState(seed + 4)
    W, n_clusters = table_width(WIDE_D), 1024
    centroids = rng.randn(n_clusters, WIDE_D).astype(np.float32)
    user_c = rng.randint(0, n_clusters, WIDE_USERS)

    def table(clusters):
        t = np.zeros((len(clusters), W), np.float32)
        noise = rng.randn(len(clusters), WIDE_D).astype(np.float32)
        t[:, :WIDE_D] = (centroids[clusters] + noise) / np.float32(np.sqrt(WIDE_D))
        t[:, -1] = 0.1 * rng.randn(len(clusters))
        return t

    arrays = {"item_table": table(np.arange(N_ITEMS) % n_clusters), "user_table": table(user_c)}
    for side in ("item", "user"):
        arrays[f"{side}_acc"] = np.ones_like(arrays[f"{side}_table"])
        arrays[f"{side}_mom"] = np.zeros_like(arrays[f"{side}_table"])
        arrays[f"{side}_log_scale"] = np.float32(0)
    cols = np.stack([c + n_clusters * rng.choice((N_ITEMS - c - 1) // n_clusters + 1,
                                                 T_TEST + N_TRAIN, replace=False)
                     for c in user_c])

    def csr(block):
        rows = np.repeat(np.arange(WIDE_USERS), block.shape[1])
        return sp.csr_matrix((np.ones(rows.size, np.float32), (rows, block.ravel())),
                             shape=(WIDE_USERS, N_ITEMS))

    test, train = csr(cols[:, :T_TEST]), csr(cols[:, T_TEST:])
    model = LightFM(no_components=WIDE_D, random_state=seed)
    model._state = interop.state_from_numpy(arrays, model.device)
    model.n_users_, model.n_items_ = WIDE_USERS, N_ITEMS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ranks, launches = counted(rc, model.predict_rank, test, train_interactions=train)
    torch.cuda.synchronize()
    log(f"  predict_rank D={WIDE_D} (Wa={W + 1}), {WIDE_USERS} users: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, launches {launches}")
    check(launches["rank_counts"] > 0 and launches["pair_scores"] > 0,
          f"D={WIDE_D}: predict_rank went through both rank kernels")
    check(bool((ranks.data >= 0).all() and (ranks.data <= N_ITEMS - 1 - N_TRAIN).all()),
          f"D={WIDE_D}: every rank lies in [0, n_items - 1 - n_train(u)]")
    users = np.random.RandomState(seed + 6).choice(WIDE_USERS, 64, replace=False)
    n_exact, n_near, widest = check_ranks_float64(
        ranks, test, train, arrays["user_table"], arrays["item_table"], users)
    check(n_exact > 0.9 * (n_exact + n_near),
          f"D={WIDE_D}: 64 users' ranks equal float64 numpy ({n_exact} exact, {n_near} "
          f"near ties in bounds, widest band {widest} ranks)")
    return launches


def serving_path(torch, seed: int) -> dict:
    """Phase 3: predict_rank + metrics, recommend and predict at full width.
    Each path runs with the launch counts set to 0 just before it; returns
    the counts of the main path, one ``predict_rank`` call."""
    from lightfm_tpu_torch import LightFM, evaluation, interop, observability
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
    clamped0 = observability.device_counter(ranking.CLAMPED)
    (ranks, first), main = counted(rc, timed_predict_rank, torch, ranking, model, test, train)
    path_launches["predict_rank"] = main
    (again, second), path_launches["predict_rank (prep cached)"] = counted(
        rc, timed_predict_rank, torch, ranking, model, test, train
    )
    for what, b in (("first call", first), ("second call, prep cached", second)):
        log(f"  predict_rank {what}: " + json.dumps(b))
    clamped = observability.device_counter(ranking.CLAMPED) - clamped0
    log(f"  kernel launches of one predict_rank: {main}; clamped: {clamped}")
    check(main["rank_counts"] > 0 and main["pair_scores"] > 0,
          "predict_rank went through both kernels")
    check(path_launches["predict_rank (prep cached)"] == main,
          "the cached call launches the same kernels")
    check(np.array_equal(ranks.data, again.data), "two predict_rank calls give equal ranks")
    check(clamped == 0, "the self-match clamp never changed a rank")
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
    path_launches["predict_rank (D=712)"] = wide_rank_check(torch, seed)

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
    check(observability.device_counter(ranking.CLAMPED) == clamped0,
          "no predict_rank call of phase 3 clamped a rank")
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


def uniform_touches(rng, M: int, R: int, W: int, n_hot: int = 0):
    """M sorted touches of an R-row table, uniform over the rows; with
    ``n_hot`` > 0, row R // 2 holds exactly ``n_hot`` of them and the rest
    are uniform over the other rows (one run of n_hot touches)."""
    if n_hot:
        rows = rng.randint(0, R - 1, M - n_hot)
        rows[rows >= R // 2] += 1
        rows = np.concatenate([rows, np.full(n_hot, R // 2)])
    else:
        rows = rng.randint(0, R, M)
    return np.sort(rows).astype(np.int32), (0.1 * rng.randn(M, W)).astype(np.float32)


def edge_touches(rng, R: int, W: int, L: int):
    """Sorted touches laid out against the kernel's segments of L positions:
    runs of L - 1, L, L + 1 and 2L + 1 touches, each starting on a segment
    edge (the run of L ends exactly on the next), short runs between them, a
    run of negative rows and one of rows >= R that cross edges (both
    ignored), and a length that is not a multiple of L."""
    runs = [(-7, L + 3), (-1, L - 2)]
    pos, row = 2 * L + 1, 0
    for length in [L - 1, L, L + 1, 2 * L + 1] * 5:
        while pos % L:
            k = min(1 + rng.randint(0, 3), L - pos % L)
            runs.append((row, k))
            row, pos = row + 1 + rng.randint(0, 3), pos + k
        runs.append((row, length))
        row, pos = row + 1, pos + length
    runs += [(row + 1, 37), (R, L + 5), (R + 3, 2 * L)]
    assert row + 1 < R
    rows = np.concatenate([np.full(n, r) for r, n in runs]).astype(np.int32)
    assert rows.size % L
    return rows, (0.1 * rng.randn(rows.size, W)).astype(np.float32)


def touch_cases(rng, M: int, W: int, L: int) -> list:
    """The touch layouts phases 4 (K1) and 4b (K3) run, as (name, table
    rows, width, maker): Zipf touches over the item and the user table,
    uniform touches, one hot row of n touches for n from 1 to all M, all at
    M touches of width W; then touches laid out against the kernels'
    segments of L at W = 8, 40, 72 and 136."""
    cases = [("Zipf items", TRAIN_ITEMS, W, lambda: zipf_touches(rng, M, TRAIN_ITEMS, W)),
             ("Zipf users", TRAIN_USERS, W, lambda: zipf_touches(rng, M, TRAIN_USERS, W)),
             ("uniform items", TRAIN_ITEMS, W, lambda: uniform_touches(rng, M, TRAIN_ITEMS, W))]
    cases += [(f"hot row n={n}", TRAIN_ITEMS, W,
               lambda n=n: uniform_touches(rng, M, TRAIN_ITEMS, W, n_hot=n))
              for n in sorted({1, 64, 65, 4096, 65536, M}) if n <= M]
    cases += [(f"segment edges W={w}", 5000, w, lambda w=w: edge_touches(rng, 5000, w, L))
              for w in (8, 40, 72, 136)]
    return cases


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def device_ms(torch, fn, reps: int = 10) -> dict:
    """``torch.profiler``'s device time of one call of ``fn``: the CUDA
    kernels it launched over ``reps`` calls, by kernel name, in ms a call
    ({} when the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: _device_us(e) / 1e3 / reps for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0}


def host_ms(torch, fn, reps: int = 20) -> float:
    """Host-clock time to enqueue one call of ``fn`` (no synchronise between
    calls): the wrapper's own cost a call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def update_tolerance(torch, table, acc, sidx, wg):
    """Per-element bound on |kernel - plain|: each side sums a row's n_r
    touches in fp32 in its own order, so each is within (n_r + 2) * 2^-23 *
    (sum of |terms| + |start value|) of the exact result (recursive-
    summation worst case plus the final multiply and add); twice that
    bounds their difference."""
    R, W = table.shape
    keep = (sidx >= 0) & (sidx < R)
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


def chunk_tolerance(torch, table, acc, skeys, order, wg):
    """The step over the touches keyed in ``[0, R)``, in float64 (the sums
    and ``lr * rsqrt(acc)``, with fp32 ``lr``), and a per-element bound on
    ``touch_adagrad_update``'s distance from it.  The kernel sums a row's
    touches in chunks of ``au.CHUNK`` in order, then the row's n_c chunk
    sums (one by one, or in a tree no deeper than that): each sum is within
    (CHUNK + n_c) * 2^-24 * sum|terms| of the exact one.  The bound takes
    twice that, plus 4 ulps of the step (``rsqrtf``'s 2 and the two
    rounded multiplies) and one of each result.  Returns ``(table, acc,
    t_tol, a_tol)``, all float64."""
    from lightfm_tpu_torch.ops import adagrad_update as au

    R, W = table.shape
    live = (skeys >= 0) & (skeys < R)
    rows = skeys[live].long()
    g = wg[order[live]].double()
    n = torch.zeros(R, dtype=torch.float64, device=table.device)
    n.index_add_(0, rows, torch.ones_like(rows, dtype=torch.float64))
    s = torch.zeros((R, W), dtype=torch.float64, device=table.device).index_add_(0, rows, g)
    s_abs = torch.zeros_like(s).index_add_(0, rows, g.abs())
    s2 = torch.zeros_like(s).index_add_(0, rows, g * g)
    eps = 2.0**-23
    sums = (au.CHUNK + torch.ceil(n / au.CHUNK))[:, None] * eps
    lr_local = float(np.float32(LR)) * torch.rsqrt(acc.double())
    step = lr_local * s
    t_exact, a_exact = table.double() - step, acc.double() + s2
    t_tol = lr_local * sums * s_abs + 4 * eps * step.abs() + eps * t_exact.abs()
    a_tol = sums * s2 + eps * a_exact.abs()
    return t_exact, a_exact, t_tol, a_tol


def update_bound_ms(M: int, W: int, distinct: int) -> float:
    """K1's least time: the touches (ids and gradients) read once, and table
    and acc read and written once for each distinct touched row."""
    return (4 * M * (W + 1) + 16 * W * distinct) / HBM_BYTES_PER_S * 1e3


def check_update(torch, au, what: str, table0, acc0, sidx, wg, reps: int = 20) -> dict:
    """K1 against its plain version on one set of sorted touches: at both
    precisions within the summation-order bound, two launches bitwise
    equal and untouched rows bitwise unchanged; all-masked calls (zero
    gradients, every row >= R, every row negative) change nothing.  Returns
    the case's record at "default": the largest difference, the kernel's
    CUDA-event time back to back (``ms``), its device time from the
    profiler by kernel (``device_ms``), the host time to enqueue a call,
    the plain version's time and the bound."""
    R, W = table0.shape
    M = sidx.shape[0]
    ok = (sidx >= 0) & (sidx < R)
    runs = torch.unique_consecutive(sidx[ok], return_counts=True)[1]
    untouched = torch.ones(R, dtype=torch.bool, device=sidx.device)
    untouched[sidx[ok].long()] = False
    t_tol, a_tol = update_tolerance(torch, table0, acc0, sidx, wg)

    def run(fn, prec="default", s=sidx, g=wg):
        t, a = table0.clone(), acc0.clone()
        fn(t, a, s, g, LR, prec)
        torch.cuda.synchronize()
        return t, a

    worst = 0.0
    for prec in au.PRECISIONS:
        t1, a1 = run(au.sorted_adagrad_update, prec)
        t2, a2 = run(au.sorted_adagrad_update, prec)
        check(torch.equal(t1, t2) and torch.equal(a1, a2), f"{what} {prec}: two launches are bitwise equal")
        tp, ap = run(au.sorted_adagrad_update_plain, prec)
        dt, da = (t1 - tp).abs(), (a1 - ap).abs()
        worst = max(worst, float(dt.max()), float(da.max()))
        check(bool((dt <= t_tol).all() and (da <= a_tol).all()),
              f"{what} {prec}: kernel equals plain within the summation-order bound "
              f"(max |d| table {float(dt.max()):.3g}, acc {float(da.max()):.3g})")
        check(torch.equal(t1[untouched], table0[untouched])
              and torch.equal(a1[untouched], acc0[untouched]),
              f"{what} {prec}: untouched rows are bitwise unchanged")
    for masked, s, g in (
        ("zero gradients", sidx, torch.zeros_like(wg)),
        ("every row >= R", torch.full_like(sidx, 2**30), wg),
        ("every row negative", torch.full_like(sidx, -3), wg),
    ):
        t1, a1 = run(au.sorted_adagrad_update, "default", s, g)
        check(torch.equal(t1, table0) and torch.equal(a1, acc0),
              f"{what}: an all-masked call ({masked}) changes nothing")
    del t_tol, a_tol
    tw, aw = table0.clone(), acc0.clone()

    def kernel():
        au.sorted_adagrad_update(tw, aw, sidx, wg, LR, "default")

    split = device_ms(torch, kernel)
    distinct = int(runs.numel())
    rec = {
        "M": M, "W": W, "R": R, "distinct": distinct, "hottest": int(runs.max()) if distinct else 0,
        "ms": time_ms(torch, kernel, reps=reps), "device_ms": sum(split.values()),
        "device_split": split, "host_ms": host_ms(torch, kernel),
        "plain_ms": time_ms(torch, lambda: au.sorted_adagrad_update_plain(
            tw, aw, sidx, wg, LR, "default"), reps=5),
        "bound_ms": update_bound_ms(M, W, distinct), "max_abs_err": worst,
    }
    log(f"  {what}: " + json.dumps(rec))
    return rec


def update_kernel_checks(torch, seed: int) -> dict:
    """Phase 4: K1 against its plain version (``check_update``) at the
    training step's shape (M = 131,072 touches, W = 72) on Zipf touches over
    the item and the user table, on uniform touches, and with one hot row of
    n touches for n from 1 to all M; then on touches laid out against the
    kernel's segments (runs of L - 1, L, L + 1 and 2L + 1 from an edge,
    sentinel runs across edges, M not a multiple of L) at W = 8, 40, 72 and
    136; K4 once.  Returns the largest difference and every case's record."""
    from lightfm_tpu_torch.ops import _build
    from lightfm_tpu_torch.ops import adagrad_update as au
    from lightfm_tpu_torch.state import table_width

    dev = torch.device(DEVICE)
    rng = np.random.RandomState(seed + 3)
    M, W, L = TRAIN_BATCH, table_width(D), au.SEGMENT
    log(f"phase 4: adagrad update kernel (K1) vs plain, segments of {L} touches")
    ptxas = [ln.strip() for ln in _build.build_log("adagrad_update").splitlines()
             if "registers" in ln or "spill" in ln]
    for ln in ptxas:
        log(f"  ptxas adagrad_update: {ln}")
    check(all(" 0 bytes spill stores, 0 bytes spill loads" in ln for ln in ptxas if "spill" in ln),
          f"ptxas: no adagrad_update function spills ({len(ptxas)} lines)")

    out, worst = {}, 0.0
    for what, R, w, make in touch_cases(rng, M, W, L):
        sidx_np, wg_np = make()
        sidx, wg = torch.from_numpy(sidx_np).to(dev), torch.from_numpy(wg_np).to(dev)
        table0 = torch.from_numpy((0.1 * rng.randn(R, w)).astype(np.float32)).to(dev)
        acc0 = torch.from_numpy((1.0 + rng.rand(R, w)).astype(np.float32)).to(dev)
        out[what] = check_update(torch, au, what, table0, acc0, sidx, wg)
        worst = max(worst, out[what]["max_abs_err"])
        if what == "Zipf items":  # K4 once: the same touches in random order
            order = torch.from_numpy(rng.permutation(M)).to(dev)
            s, g = sidx[order].contiguous(), wg[order].contiguous()
            t1, a1 = table0.clone(), acc0.clone()
            au.adagrad_update(t1, a1, s, g, LR, "default")
            tp, ap = table0.clone(), acc0.clone()
            au.sorted_adagrad_update_plain(tp, ap, s, g, LR, "default")
            t_tol, a_tol = update_tolerance(torch, table0, acc0, sidx, wg)
            err = max(float((t1 - tp).abs().max()), float((a1 - ap).abs().max()))
            check(bool(((t1 - tp).abs() <= t_tol).all() and ((a1 - ap).abs() <= a_tol).all()),
                  f"K4 (argsort + K1) equals plain within the same bound (max |d| {err:.3g})")
            worst = max(worst, err)
            del t_tol, a_tol
        del sidx, wg, table0, acc0
        torch.cuda.empty_cache()
    if dev.type == "cuda":
        # The kernel stages gradient rows with 16-byte copies: a gradient
        # view that starts 4 bytes into its allocation is copied by the
        # wrapper (the same result as an aligned copy, bitwise), and a width
        # that is not a multiple of 4 is refused.
        sidx_np, wg_np = edge_touches(rng, 5000, 40, L)
        sidx = torch.from_numpy(sidx_np).to(dev)
        view = torch.empty(wg_np.size + 1, device=dev)[1:].view(wg_np.shape)
        view.copy_(torch.from_numpy(wg_np))
        table0 = torch.from_numpy((0.1 * rng.randn(5000, 40)).astype(np.float32)).to(dev)
        acc0 = torch.from_numpy((1.0 + rng.rand(5000, 40)).astype(np.float32)).to(dev)
        got, want = [(table0.clone(), acc0.clone()) for _ in range(2)]
        au.sorted_adagrad_update(*got, sidx, view, LR, "default")
        au.sorted_adagrad_update(*want, sidx, view.clone(), LR, "default")
        check(view.data_ptr() % 16 != 0 and torch.equal(got[0], want[0])
              and torch.equal(got[1], want[1]),
              "K1 on a gradient view off a 16-byte boundary equals K1 on an aligned copy")
        odd = torch.zeros((100, 37), device=dev)
        try:
            au.sorted_adagrad_update(odd, odd.clone(), sidx[:5].clamp(0, 99),
                                     torch.zeros((5, 37), device=dev), LR)
            refused = False
        except ValueError:
            refused = True
        check(refused, "K1 refuses a table width that is not a multiple of 4 on the card")
    sweep = {k: v["device_ms"] for k, v in out.items() if k.startswith("hot row")}
    log(f"  K1 device ms by hot-row length: {json.dumps(sweep)}")
    return {"worst": worst, "cases": out}


def sums_tolerance(torch, sidx, wg, n_rows: int):
    """Per-element bound on |kernel - plain| for K3: each side sums a row's
    n_r terms (wg, and wg^2 in the second half) in fp32 in its own order, so
    each is within (n_r + 1) * 2^-23 * sum|terms| of the exact sum; twice
    that bounds their difference."""
    keep = (sidx >= 0) & (sidx < n_rows)
    rows = sidx[keep].long()
    g = wg[keep].double()
    n = torch.zeros(n_rows, dtype=torch.float64, device=wg.device)
    n.index_add_(0, rows, torch.ones_like(rows, dtype=torch.float64))
    terms = torch.zeros((n_rows, 2 * wg.shape[1]), dtype=torch.float64, device=wg.device)
    terms.index_add_(0, rows, torch.cat([g.abs(), g * g], dim=1))
    return 2 * (n[:, None] + 1) * 2.0**-23 * terms


def sums_bound_ms(M: int, W: int, n_rows: int) -> float:
    """K3's least time: the touches (ids and gradients) read once and the
    whole [n_rows, 2W] output written once."""
    return (4 * M * (W + 1) + 8 * W * n_rows) / HBM_BYTES_PER_S * 1e3


def check_grad_sums(torch, gs, sidx, wg, n_rows: int, what: str, reps: int = 20) -> dict:
    """K3 against its plain version on one set of sorted touches, at both
    precisions: two launches bitwise equal, within the summation-order
    bound, untouched rows exactly 0, and out-of-range touches ignored (other
    gradients on them change nothing, bitwise).  Returns the case's record
    at "default": the largest difference, the kernel's CUDA-event time back
    to back (``ms``), its device time from the profiler by kernel
    (``device_ms``), the host time to enqueue a call, the plain version's
    time, the library call's (``zeros`` + ``index_add_`` of ``[wg | wg^2]``)
    and the bound."""
    M, W = wg.shape
    tol = sums_tolerance(torch, sidx, wg, n_rows)
    in_range = (sidx >= 0) & (sidx < n_rows)
    runs = torch.unique_consecutive(sidx[in_range], return_counts=True)[1]
    untouched = torch.ones(n_rows, dtype=torch.bool, device=sidx.device)
    untouched[sidx[in_range].long()] = False
    other = wg.clone()
    other[~in_range] = 3 * other[~in_range] + 1
    worst = 0.0
    for prec in gs.PRECISIONS:
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
            c = gs.sorted_grad_sums(sidx, other, n_rows, prec)
            check(torch.equal(a, c), f"K3 {what} {prec}: out-of-range touches are ignored "
                                     "(other gradients on them change nothing, bitwise)")
    del tol, other, a, b, d

    def kernel():
        gs.sorted_grad_sums(sidx, wg, n_rows, "default")

    rows = sidx[in_range].long()
    both = torch.cat([wg[in_range], wg[in_range] * wg[in_range]], dim=1)

    def library():
        torch.zeros((n_rows, 2 * W), dtype=torch.float32, device=wg.device).index_add_(0, rows, both)

    split = device_ms(torch, kernel)
    distinct = int(runs.numel())
    rec = {
        "M": M, "W": W, "R": n_rows, "distinct": distinct,
        "hottest": int(runs.max()) if distinct else 0,
        "ms": time_ms(torch, kernel, reps=reps), "device_ms": sum(split.values()),
        "device_split": split, "host_ms": host_ms(torch, kernel),
        "plain_ms": time_ms(torch, lambda: gs.sorted_grad_sums_plain(
            sidx, wg, n_rows, "default"), reps=5),
        "library_ms": time_ms(torch, library, reps=reps),
        "bound_ms": sums_bound_ms(M, W, n_rows), "max_abs_err": worst,
    }
    log(f"  K3 {what}: " + json.dumps(rec))
    return rec


def grad_sums_checks(torch, seed: int) -> dict:
    """Phase 4b: K3 against its plain version (``check_grad_sums``) at the
    hybrid step's shape (M = 131,072 touches, W = 72) on Zipf touches over
    100,000 and 200,000 rows, on uniform touches, and with one hot row of n
    touches for n from 1 to all M; then on touches laid out against the
    kernel's segments at W = 8, 40, 72 and 136; all-out-of-range and empty
    calls; a misaligned gradient view and the W % 4 refusal once.  Returns
    the largest difference and every case's record."""
    from lightfm_tpu_torch.ops import _build
    from lightfm_tpu_torch.ops import grad_sums as gs
    from lightfm_tpu_torch.state import table_width

    dev = torch.device(DEVICE)
    rng = np.random.RandomState(seed + 5)
    M, W, L = TRAIN_BATCH, table_width(D), gs.SEGMENT
    log(f"phase 4b: gradient-sums kernel (K3) vs plain, segments of {L} touches")
    ptxas = [ln.strip() for ln in _build.build_log("grad_sums").splitlines()
             if "registers" in ln or "spill" in ln]
    for ln in ptxas:
        log(f"  ptxas grad_sums: {ln}")
    check(all(" 0 bytes spill stores, 0 bytes spill loads" in ln for ln in ptxas if "spill" in ln),
          f"ptxas: no grad_sums function spills ({len(ptxas)} lines)")

    out, worst = {}, 0.0
    for what, R, w, make in touch_cases(rng, M, W, L):
        sidx_np, wg_np = make()
        sidx, wg = torch.from_numpy(sidx_np).to(dev), torch.from_numpy(wg_np).to(dev)
        out[what] = check_grad_sums(torch, gs, sidx, wg, R, what)
        worst = max(worst, out[what]["max_abs_err"])
        del sidx, wg
        torch.cuda.empty_cache()
    sweep = {k: (v["ms"], v["device_ms"]) for k, v in out.items() if k.startswith("hot row")}
    log(f"  K3 (events ms, device ms) by hot-row length: {json.dumps(sweep)}")

    sidx_np, wg_np = edge_touches(rng, 5000, 40, L)
    sidx, wg = torch.from_numpy(sidx_np).to(dev), torch.from_numpy(wg_np).to(dev)
    for what, s in (("every row out of range", torch.full_like(sidx, 2**30)),
                    ("every row negative", torch.full_like(sidx, -3)),
                    ("no touches", sidx[:0])):
        z = gs.sorted_grad_sums(s, wg[: s.shape[0]], 5000, "default")
        check(z.shape == (5000, 80) and not bool(z.any()), f"K3: {what} gives exact zeros")
    if dev.type == "cuda":
        # The kernel stages gradient rows with 16-byte copies: a gradient
        # view that starts 4 bytes into its allocation is copied by the
        # wrapper (the same result as an aligned copy, bitwise), and a width
        # that is not a multiple of 4 is refused.
        view = torch.empty(wg_np.size + 1, device=dev)[1:].view(wg_np.shape)
        view.copy_(wg)
        got = gs.sorted_grad_sums(sidx, view, 5000, "default")
        check(view.data_ptr() % 16 != 0
              and torch.equal(got, gs.sorted_grad_sums(sidx, view.clone(), 5000, "default")),
              "K3 on a gradient view off a 16-byte boundary equals K3 on an aligned copy")
        try:
            gs.sorted_grad_sums(sidx[:5].clamp(0, 99), torch.zeros((5, 37), device=dev), 100)
            refused = False
        except ValueError:
            refused = True
        check(refused, "K3 refuses a gradient width that is not a multiple of 4 on the card")
    return {"worst": worst, "cases": out}


# The generic step's adagrad pass (phase 4c) at warp-hybrid-l2's shapes: a
# step's item touches (the 8 tag slots of each example's positive and
# negative item, 2 x 8 x 131,072 = 2,097,152) on 2,048 tag rows, W = 32
# (D = 30), the hottest tag ~65,000 slots; the user touches, one a batch row, on 200,000
# users.  About a third of the item slots are live (real tags of examples
# that update), half the user rows.
HYB_TAGS, HYB_W, HYB_ITEM_SLOTS, HYB_ZIPF = 2048, 32, 16 * TRAIN_BATCH, 0.7


def hybrid_touches(rng, which: str):
    """(R, idx, mask) of one table's touches in touch order at the hybrid
    cell's shape: ``"item"``: tag rows by a Zipf law of exponent HYB_ZIPF
    (the hottest ~3% of the slots), a third live; ``"user"``: uniform over
    TRAIN_USERS, one a batch row, half live."""
    if which == "item":
        p = 1.0 / np.arange(1, HYB_TAGS + 1) ** HYB_ZIPF
        idx = rng.choice(HYB_TAGS, HYB_ITEM_SLOTS, p=p / p.sum())
        return HYB_TAGS, idx, rng.rand(HYB_ITEM_SLOTS) < 1 / 3
    return TRAIN_USERS, rng.randint(0, TRAIN_USERS, TRAIN_BATCH), rng.rand(TRAIN_BATCH) < 0.5


def touch_update_checks(torch, seed: int) -> dict:
    """Phase 4c: ``touch_adagrad_update``, the generic step's adagrad pass,
    against its plain version at the hybrid cell's item and user shapes
    (``hybrid_touches``), each fed the keys ``sparse_update`` builds
    (``touch_order``): two launches bitwise equal; kernel and plain within
    the summation-order bound, and the kernel within its chunked order's
    bound of the float64 step (``chunk_tolerance``); untouched rows bitwise
    unchanged; the live
    touches alone, each ``"rows"`` part of two (``TablePlacement.own``) and
    each ``"components"`` part of 2, 8 and 16 columns bitwise the whole
    call's rows and columns; an all-masked call a no-op.  Times: the kernel
    (CUDA events and profiler), the sort, the plain version and PyTorch's
    ``index_put_`` pair the kernel replaced (``library_ms``), beside the
    bound on the live touches (``update_bound_ms``).  Then one epoch of a
    generic hybrid fit (tags, ``item_alpha``) under a recording: every step
    launches the kernel on both tables inside its ``kernel.touch_adagrad``
    span and counts live touches on both ``update_kernel_touches.*``."""
    from lightfm_tpu_torch.ops import _build
    from lightfm_tpu_torch.ops import adagrad_update as au
    from lightfm_tpu_torch.ops.updates import touch_order
    from lightfm_tpu_torch.parallel.mesh import TablePlacement

    dev = torch.device(DEVICE)
    rng = np.random.RandomState(seed + 7)
    log(f"phase 4c: the generic step's adagrad kernel (touch_adagrad_update) vs plain, chunks "
        f"of {au.CHUNK} touches, W={HYB_W}")
    ptxas = [ln.strip() for ln in _build.build_log("adagrad_update").splitlines()
             if "registers" in ln or "spill" in ln]
    check(all(" 0 bytes spill stores, 0 bytes spill loads" in ln for ln in ptxas if "spill" in ln),
          f"ptxas: no adagrad_update function spills ({len(ptxas)} lines)")
    out, worst = {}, 0.0
    for which in ("item", "user"):
        R, idx_np, mask_np = hybrid_touches(rng, which)
        M = idx_np.size
        idx = torch.from_numpy(idx_np).to(dev)
        mask = torch.from_numpy(mask_np).to(dev)
        wg = torch.from_numpy((0.1 * rng.randn(M, HYB_W)).astype(np.float32)).to(dev)
        wg *= mask[:, None]  # as sparse_update's (w * mask) * g
        table0 = torch.from_numpy((0.1 * rng.randn(R, HYB_W)).astype(np.float32)).to(dev)
        acc0 = torch.from_numpy((1.0 + rng.rand(R, HYB_W)).astype(np.float32)).to(dev)
        skeys, order = touch_order(idx, mask, R)

        def run(fn, t0=table0, a0=acc0, k=skeys, o=order, g=wg):
            t, a = t0.clone(), a0.clone()
            fn(t, a, k, o, g, LR)
            torch.cuda.synchronize()
            return t, a

        t1, a1 = run(au.touch_adagrad_update)
        t2, a2 = run(au.touch_adagrad_update)
        check(torch.equal(t1, t2) and torch.equal(a1, a2),
              f"{which}: two launches are bitwise equal")
        tp, ap = run(au.touch_adagrad_update_plain)
        live = skeys < R
        t_tol, a_tol = update_tolerance(torch, table0, acc0, skeys[live], wg[order[live]])
        dt, da = (t1 - tp).abs(), (a1 - ap).abs()
        err = max(float(dt.max()), float(da.max()))
        worst = max(worst, err)
        check(bool((dt <= t_tol).all() and (da <= a_tol).all()),
              f"{which}: kernel equals plain within the summation-order bound (max |d| table "
              f"{float(dt.max()):.3g}, acc {float(da.max()):.3g})")
        del t_tol, a_tol, tp, ap
        # The plain version's own order bounds it loosely ((n + 2) ulps of a
        # row's n touches); against float64 the kernel is held to its
        # chunked order's bound, tight enough that a lost chunk shows.
        t64, a64, t_tol, a_tol = chunk_tolerance(torch, table0, acc0, skeys, order, wg)
        dt, da = (t1.double() - t64).abs(), (a1.double() - a64).abs()
        share = max(float((dt / t_tol.clamp_min(1e-300)).max()),
                    float((da / a_tol.clamp_min(1e-300)).max()))
        check(share <= 1.0, f"{which}: kernel within its chunked order's bound of the float64 "
              f"step (worst {share:.3g} of the bound; max |d| table {float(dt.max()):.3g}, "
              f"acc {float(da.max()):.3g})")
        del t64, a64, t_tol, a_tol, dt, da
        untouched = torch.ones(R, dtype=torch.bool, device=dev)
        untouched[idx[mask]] = False
        check(torch.equal(t1[untouched], table0[untouched])
              and torch.equal(a1[untouched], acc0[untouched]),
              f"{which}: untouched rows are bitwise unchanged")
        # The live touches alone, sorted as sparse_update sorts them.
        keep = torch.nonzero(mask)[:, 0]
        ones = torch.ones(keep.numel(), dtype=torch.bool, device=dev)
        lk, lo = touch_order(idx[keep], ones, R)
        t3, a3 = run(au.touch_adagrad_update, k=lk, o=lo, g=wg[keep].contiguous())
        check(torch.equal(t3, t1) and torch.equal(a3, a1),
              f"{which}: the live touches alone give bitwise the same table and acc")
        same = []
        for layout, n in (("rows", 2), ("components", 16), ("components", 4),
                          ("components", 2)):
            size = (R if layout == "rows" else HYB_W) // n
            for k in range(n):
                place = TablePlacement(None, layout, k * size, (k + 1) * size, (R, HYB_W))
                li, lm, lg, _ = place.own(idx, mask, wg)
                rows = slice(k * size, (k + 1) * size) if layout == "rows" else slice(0, R)
                cols = (slice(k * size, (k + 1) * size) if layout == "components"
                        else slice(0, HYB_W))
                lk, lo = touch_order(li, lm, rows.stop - rows.start)
                tk, ak = run(au.touch_adagrad_update, table0[rows, cols].contiguous(),
                             acc0[rows, cols].contiguous(), lk, lo, lg.contiguous())
                same.append(torch.equal(tk, t1[rows, cols]) and torch.equal(ak, a1[rows, cols]))
        check(all(same), f"{which}: each rows part of 2 and each components part of 2, 8 and 16 "
              f"columns is bitwise the whole call's ({sum(same)} of {len(same)} parts)")
        tz, az = run(au.touch_adagrad_update, k=torch.full_like(skeys, R))
        check(torch.equal(tz, table0) and torch.equal(az, acc0),
              f"{which}: an all-masked call changes nothing")
        del t1, a1, t2, a2, t3, a3, tz, az
        tw, aw = table0.clone(), acc0.clone()

        def kernel():
            au.touch_adagrad_update(tw, aw, skeys, order, wg, LR)

        lr_local = LR * torch.rsqrt(acc0[idx])

        def library():  # the parent's two ordered scatter-adds
            tw.index_put_((idx,), -(lr_local * wg), accumulate=True)
            aw.index_put_((idx,), wg * wg, accumulate=True)

        runs = torch.unique_consecutive(skeys[live], return_counts=True)[1]
        split = device_ms(torch, kernel)
        rec = {
            "M": M, "W": HYB_W, "R": R, "live": int(live.sum()), "distinct": int(runs.numel()),
            "hottest": int(runs.max()), "ms": time_ms(torch, kernel, reps=20),
            "device_ms": sum(split.values()), "device_split": split,
            "sort_ms": time_ms(torch, lambda: touch_order(idx, mask, R), reps=20),
            "plain_ms": time_ms(torch, lambda: au.touch_adagrad_update_plain(
                tw, aw, skeys, order, wg, LR), reps=5),
            "library_ms": time_ms(torch, library, reps=5),
            "bound_ms": update_bound_ms(int(live.sum()), HYB_W, int(runs.numel())),
            "max_abs_err": err, "share_of_f64_bound": share,
        }
        log(f"  {which}: " + json.dumps(rec))
        out[which] = rec
        del idx, mask, wg, table0, acc0, skeys, order, tw, aw, lr_local
        torch.cuda.empty_cache()
    out["fit"] = touch_update_fit(torch, seed)
    return {"worst": worst, "cases": out}


def touch_update_fit(torch, seed: int) -> dict:
    """Phase 4c's fit: one epoch of ``LightFM(loss="warp", item_alpha=1e-6,
    no_components=30)`` on phase 5's interactions with tag features alone
    (the generic path), every step read from a recording: the kernel's
    spans, and the device counters read after each step (a wrapper around
    the WARP step, which synchronises)."""
    from lightfm_tpu_torch import LightFM, losses, observability
    from lightfm_tpu_torch.ops import adagrad_update as au

    coo = clustered_interactions(TRAIN_USERS, TRAIN_ITEMS, TRAIN_NNZ, seed)
    tags = tag_features(TRAIN_ITEMS, seed=seed + 3)[:, TRAIN_ITEMS:].tocsr()
    step = losses.LOSS_STEPS["warp"]
    names = ("update_kernel_touches.item", "update_kernel_touches.user")
    per_step = []

    def counted(*args, **kwargs):
        before = [observability.device_counter(n) for n in names]
        state = step(*args, **kwargs)
        per_step.append([observability.device_counter(n) - b for n, b in zip(names, before)])
        return state

    model = LightFM(loss="warp", item_alpha=1e-6, no_components=30, batch_size=TRAIN_BATCH,
                    random_state=seed, device=DEVICE)
    au.reset_launches()
    losses.LOSS_STEPS["warp"] = counted
    try:
        with observability.recording() as rec:
            model.fit(coo, item_features=tags, epochs=1)
    finally:
        losses.LOSS_STEPS["warp"] = step
    steps = rec.named("step")
    spans = rec.named("kernel.touch_adagrad")
    check(model._staged_fast is False, "the hybrid fit with item_alpha took the generic path")
    check(len(steps) == len(per_step) > 0 and len(spans) == 2 * len(steps)
          and au.launches["touch_adagrad_update"] == 2 * len(steps),
          f"touch_adagrad_update launched twice a step inside kernel.touch_adagrad spans "
          f"({len(spans)} spans, {au.launches['touch_adagrad_update']} launches, "
          f"{len(steps)} steps)")
    check(all(i > 0 and u > 0 for i, u in per_step),
          "update_kernel_touches.item and .user grow on every step")
    out = {"steps": len(steps), "launches": au.launches["touch_adagrad_update"],
           "kernel_touches_item": [i for i, _ in per_step],
           "kernel_touches_user": [u for _, u in per_step],
           "span_ms": float(np.mean([(s.end_ns - s.start_ns) / 1e6 for s in spans]))}
    log("  hybrid fit, one epoch: " + json.dumps(out))
    return out


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


def profiled_epoch(torch, train, model, seed: int) -> dict:
    """One more epoch of the fitted model (through ``train.run_epochs`` on
    its staged data, so no host prep) under ``torch.profiler``: the epoch's
    host-clock wall time, the device's busy time (the union of the kernel
    and copy intervals the profiler saw), the idle share, the number of
    device intervals, and the kernels that take the most device time.
    Returns the numbers (empty when the profiler saw no device time)."""
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
        return {}
    busy_ms = busy_us / 1e3
    log(f"  profiled epoch: {wall_ms:.3f} ms wall (host clock), device busy {busy_ms:.3f} ms "
        f"over {len(spans)} device intervals, idle share {1 - busy_ms / wall_ms:.4f}")

    top = sorted(
        (e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA),
        key=_device_us, reverse=True,
    )[:12]
    log("  top device kernels of the epoch (name, calls, ms): " + json.dumps(
        [(e.key[:60], e.count, _device_us(e) / 1e3) for e in top]))
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "device_intervals": len(spans)}


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
    profile = profiled_epoch(torch, train, m, seed)

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

        def kernel():
            au.sorted_adagrad_update(tw, aw, sidx, wg, LR, "default")

        k_ms = time_ms(torch, kernel, reps=20)
        split = device_ms(torch, kernel, reps=20)
        enqueue_ms = host_ms(torch, kernel)
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
        bound = update_bound_ms(M, W, distinct)
        rows[side] = {"ms": k_ms, "device_ms": sum(split.values()), "device_split": split,
                      "host_ms": enqueue_ms, "plain_ms": p_ms, "bound_ms": bound,
                      "max_abs_err": err, "distinct": distinct, "hottest": int(runs_.max()),
                      "M": M}
        if side == "items":
            order = torch.randperm(M, device=sidx.device)
            us, ug = sidx[order].contiguous(), wg[order].contiguous()
            k4_ms = time_ms(torch, lambda: au.adagrad_update(tw, aw, us, ug, LR, "default"), reps=20)
            k4_split = device_ms(torch, lambda: au.adagrad_update(tw, aw, us, ug, LR, "default"))
            k4_plain = time_ms(torch, lambda: au.sorted_adagrad_update_plain(tw, aw, us, ug, LR, "default"), reps=10)
            t4, a4 = table.clone(), acc.clone()
            _, k4_launches = counted(au.adagrad_update, t4, a4, us, ug, LR, "default")
            k4_err = max(float((t4 - tp).abs().max()), float((a4 - ap).abs().max()))
            check(k4_launches["adagrad_update"] == 1 and k4_launches["sorted_adagrad_update"] == 1,
                  "one K4 call launches K1 once")
            check(bool(((t4 - tp).abs() <= t_tol).all() and ((a4 - ap).abs() <= a_tol).all()),
                  f"K4 on the step's shuffled items equals plain within the bound")
            rows["k4"] = {"ms": k4_ms, "device_ms": sum(k4_split.values()),
                          "device_split": k4_split, "plain_ms": k4_plain, "bound_ms": bound,
                          "launches": k4_launches["adagrad_update"], "max_abs_err": k4_err}
        del tw, aw, tk, ak, tp, ap, t_tol, a_tol
    log("  K1/K4 on the real step touches (ms, default precision): " + json.dumps(rows))
    torch.cuda.empty_cache()
    return {"launches": launches, "rows": rows, "steady_ms": steady_ms, "profile": profile,
            "steps": steps}


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
    row = check_grad_sums(torch, gs, sidx.contiguous(), wg.contiguous(), n_rows,
                          "on the step's item touches")
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


CHAIN_TRIPS = 7  # L2 trips on a K5 step's critical path (csrc/warp_fit.cu's note)


def k5_probes(torch, wf):
    """K5's two chain-floor probes (``csrc/warp_fit.cu``), as functions of
    their size returning ms: one ``grid.sync()`` of an empty cooperative
    grid of ``blocks`` blocks (2,001 barriers against 1), and one L2 (or
    device-memory) trip of one thread chasing a ring of ``n_el`` indices
    for 200,000 hops."""
    lib = wf._lib()
    dev = torch.device("cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def probe(code):
        if code:
            raise RuntimeError(f"probe launch failed: {lib.warp_fit_error_string(code).decode()}")

    def barrier_ms(blocks):
        def syncs(n):
            return lambda: probe(lib.warp_fit_sync_probe(blocks, n, stream))
        return (time_ms(torch, syncs(2001), reps=3) - time_ms(torch, syncs(1), reps=3)) / 2000

    def trip_ms(n_el, hops=200_000):
        perm = np.random.RandomState(1).permutation(n_el).astype(np.int32)
        ring = np.empty(n_el, np.int32)
        ring[perm] = np.roll(perm, -1)
        ring_t = torch.from_numpy(ring).to(dev)
        out = torch.zeros(1, dtype=torch.int32, device=dev)
        return time_ms(torch, lambda: probe(lib.warp_fit_chase_probe(
            ring_t.data_ptr(), hops, out.data_ptr(), stream)), reps=3) / hops

    return barrier_ms, trip_ms


def chain_floor(torch, wf, S: int) -> dict:
    """K5's chain floor: S steps x (2 grid-wide barriers on the fit's
    default grid + CHAIN_TRIPS L2 trips, a ring of 4 MB, which the L2
    holds after the warm-up)."""
    barrier, trip = k5_probes(torch, wf)
    blocks = torch.cuda.get_device_properties(0).multi_processor_count  # the default grid
    barrier_ms, trip_ms = barrier(blocks), trip(1 << 20)
    floor = S * (2 * barrier_ms + CHAIN_TRIPS * trip_ms)
    log(f"  K5 chain floor: {S} steps x (2 barriers of {barrier_ms * 1e3:.3f} us on {blocks} "
        f"blocks + {CHAIN_TRIPS} L2 trips of {trip_ms * 1e6:.1f} ns) = {floor:.3f} ms")
    return {"grid_blocks": blocks, "barrier_us": barrier_ms * 1e3, "l2_trip_ns": trip_ms * 1e6,
            "chain_floor_ms": floor}


def fit_inputs(torch, seed: int) -> dict:
    """Phase 7's inputs, made from ``seed``: the planted train set, its
    packed examples, FIT_EPOCHS shuffled epochs of batches and their
    negatives, the positives rows and a fresh state (the tables)."""
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
    return dict(train=train, packed=packed, n=n, B=B, rng=rng, batches=batches, S=S,
                positives=positives, tables=tables, batches_t=batches_t, negs_t=negs_t, kw=kw)


def warp_fit_path(torch, seed: int) -> dict:
    """Phase 7: the whole-fit WARP kernel (K5) at the quickstart's size:
    against its plain version after a few steps (and on a skewed step, at
    B = 4,096 and on other grid sizes), then a whole 30-epoch fit in one
    launch, held to the plain version's quality, with its chain floor."""
    from lightfm_tpu_torch.ops import warp_fit as wf
    from lightfm_tpu_torch.state import init_state

    dev = torch.device(DEVICE)
    inp = fit_inputs(torch, seed)
    train, packed, n, B, rng, batches, S = (
        inp[k] for k in ("train", "packed", "n", "B", "rng", "batches", "S"))
    positives, tables, batches_t, negs_t, kw = (
        inp[k] for k in ("positives", "tables", "batches_t", "negs_t", "kw"))
    W = tables[0].shape[1]
    log(f"phase 7: whole-fit WARP kernel (K5), {FIT_USERS} users x {FIT_ITEMS} items, "
        f"{n} positives, D={FIT_D} (W={W}), B={B}, K={FIT_K}, {FIT_EPOCHS} epochs = {S} steps, "
        f"positives width {positives.shape[1]}")

    names = ("user_table", "user_acc", "item_table", "item_acc")
    few = 4
    err = 0.0

    def held_to_plain(what, bt, ng, tabs=tables):
        nonlocal err
        got = wf.warp_fit_fused(*tabs, bt, ng, positives, **kw)
        want = wf.warp_fit_fused_plain(*tabs, bt, ng, positives, **kw)
        for name, g, w in zip(names, got, want):
            d = (g - w).abs()
            err = max(err, float(d.max()))
            check(bool((d <= 1e-5 + 1e-5 * w.abs()).all()),
                  f"K5 {what}: {name} equals plain to 1e-5 + 1e-5|x| (max |d| {float(d.max()):.3g})")
        return got

    got = held_to_plain(f"after {few} steps", batches_t[:few], negs_t[:few])
    # The grid's size changes no sum's order: one block, three blocks (B is
    # not a multiple of 3) and the default grid give bitwise equal fits.
    for n_blocks in (1, 3):
        again = wf.warp_fit_fused(*tables, batches_t[:few], negs_t[:few], positives, **kw,
                                  blocks=n_blocks)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K5 after {few} steps on {n_blocks} block(s) is bitwise the default grid's")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    try:
        wf.warp_fit_fused(*tables, batches_t[:1], negs_t[:1], positives, **kw, blocks=4 * sms + 1)
        refused = False
    except RuntimeError as e:
        refused = "cooperative" in str(e).lower() or "too large" in str(e).lower()
        log(f"  a grid of {4 * sms + 1} blocks: {e}")
    check(refused, "a cooperative grid larger than the card holds is refused and raises")

    # A skewed step: one item is the positive of 3 in 4 examples of each of
    # the first steps, so one block owns most of the step's touches.
    hot = batches[:few].copy()
    hot[:, 1, np.arange(B) % 4 != 0] = 7
    held_to_plain(f"skewed, item 7 the positive of 75% of {few} steps' examples",
                  torch.from_numpy(hot).to(dev), negs_t[:few])
    # B = 4,096: a step's 12,288 keys outgrow a block's list in shared memory.
    big = 4096
    n_big = -(-n // big) * big
    packed_big = np.zeros((8, n_big), np.int32)
    packed_big[:, :n] = packed[:, :n]
    bt_big = packed_big[:, rng.permutation(n_big)].reshape(8, n_big // big, big).transpose(1, 0, 2)
    ng_big = rng.randint(0, FIT_ITEMS, (bt_big.shape[0], 1, FIT_K * big)).astype(np.int32)
    check(3 * big > wf._lib().warp_fit_smem_key_capacity(), "B = 4,096 keeps its keys in device memory")
    held_to_plain(f"at B = {big}, {bt_big.shape[0]} steps",
                  torch.from_numpy(np.ascontiguousarray(bt_big)).to(dev), torch.from_numpy(ng_big).to(dev))
    # Wider tables take the kernel's other column counts, 2 and 4 a lane.
    for d in (40, 100):
        wide = init_state(d, FIT_ITEMS, FIT_USERS, np.random.RandomState(seed + d), adagrad=True,
                          device=dev)
        held_to_plain(f"at D = {d} (W = {wide.user_table.shape[1]}), {few} steps",
                      batches_t[:few], negs_t[:few],
                      (wide.user_table, wide.user_acc, wide.item_table, wide.item_acc))

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
    floor = chain_floor(torch, wf, S)
    row = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
           "bound_by": "operations" if n_ops / peak > n_bytes / HBM_BYTES_PER_S else "bytes",
           "max_abs_err": err, "launches": launches["warp_fit_fused"], "steps": S,
           "ms_per_step": k_ms / S, **floor,
           "bound_with_chain_ms": max(bound, floor["chain_floor_ms"])}
    log("  K5 whole fit (ms): " + json.dumps(row))
    return row


# Generic path (phase 8): the quickstart headline, the card against the CPU
# with the same draws, feature layouts, the 5M-interaction shape with
# fast_path="off", and mid-fit checkpoints.
QS_AUC_FLOOR = 0.90  # quickstart train AUC (phase 7's K5 fit of the same shape: 0.990)
QS_CPU_BAND = 0.02  # card vs the port's own CPU fit at the same seed
GENERIC_FULL_EPOCHS = 2


def state_excess(got, want):
    """Largest ``|got - want|`` and largest ``|got - want| - 1e-5 * |want|``
    over the eight state fields (the second at most 1e-5 passes)."""
    diff = excess = 0.0
    for g, w in zip(got, want):
        g, w = g.detach().cpu().double(), w.detach().cpu().double()
        d = (g - w).abs()
        diff = max(diff, float(d.max()))
        excess = max(excess, float((d - 1e-5 * w.abs()).max()))
    return diff, excess


def heavy_features(n_items: int, seed: int = 5):
    """Identity + the tags of :func:`tag_features`, plus 4 items carrying
    300 more tags each: over a 99th percentile of 7 entries a row, so
    ``_pad_features`` spills those rows into ``ChunkedRows`` overflow."""
    rng = np.random.RandomState(seed)
    base = tag_features(n_items)
    heavy = [rng.choice(N_TAGS, 300, replace=False) for _ in range(4)]
    rows = np.repeat([3, 97, 512, 1500], 300)
    extra = sp.coo_matrix((np.ones(rows.size, np.float32), (rows, np.concatenate(heavy) + n_items)),
                          shape=base.shape)
    out = (base + extra).tocsr()
    out.data[:] = 1.0
    return out


def generic_path(torch, seed: int, fast: dict) -> None:
    """Phase 8: ``LightFM.fit`` on the generic path (PyTorch, with its
    adagrad pass through ``touch_adagrad_update``).  Every path runs with
    the launch counts set to 0 just before it: an adagrad step launches
    ``touch_adagrad_update`` once a table and once a chunk of a
    ``ChunkedRows`` overflow tail, an adadelta step never, and no path
    launches any other hand-written kernel."""
    import tempfile

    from lightfm_tpu_torch import LightFM, interop, load_model, train
    from lightfm_tpu_torch.config import Hyperparams
    from lightfm_tpu_torch.sparse import ChunkedRows, identity_rows
    from lightfm_tpu_torch.state import table_width

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    path_launches = {}

    def step_kernels(what: str, launches: dict, data, steps: int, adadelta: bool = False) -> None:
        path_launches[what] = launches
        per_step = 0 if adadelta else sum(
            1 + (f.n_chunks if isinstance(f, ChunkedRows) else 0)
            for f in (data.item_feats, data.user_feats))
        others = {k: v for k, v in launches.items() if k != "touch_adagrad_update"}
        check(launches["touch_adagrad_update"] == per_step * steps
              and all(v == 0 for v in others.values()),
              f"{what}: touch_adagrad_update launched {per_step} times a step over {steps} steps "
              f"({launches['touch_adagrad_update']}), no other hand-written kernel")

    def fit_steps(model, epochs: int) -> int:
        return epochs * (model._staged_train_data.packed.shape[1] // model._staged_batch_size)

    def finite(state) -> bool:
        return all(bool(torch.isfinite(x).all()) for x in state)

    # (a) The quickstart headline at full width: WARP, D=10, 30 epochs.
    qs = planted_ml100k(seed)
    coo = qs.tocoo()
    log(f"phase 8: generic training path. (a) the quickstart, {FIT_USERS} users x {FIT_ITEMS} "
        f"items, {qs.nnz} positives, WARP, D={FIT_D}, {FIT_EPOCHS} epochs, automatic batch, "
        f"fast_path='auto'")
    m = LightFM(loss="warp", no_components=FIT_D, random_state=seed)
    spans = Spans(torch)
    with spans.patch([(train, "_epoch", "epoch")]):
        torch.cuda.synchronize()
        _, launches = counted_all(m.fit, coo, epochs=FIT_EPOCHS)
    torch.cuda.synchronize()
    B = m._staged_batch_size
    steps = m._staged_train_data.packed.shape[1] // B
    check(m._staged_fast is False, "the quickstart fit took the generic path (item table "
          f"{FIT_ITEMS} x {table_width(FIT_D)} under the fast path's 2^19)")
    check(all(x.device.type == dev.type for x in m._state), f"the quickstart state sits on {dev.type}")
    step_kernels(f"quickstart fit warp x{FIT_EPOCHS}", launches, m._staged_train_data,
                 FIT_EPOCHS * steps)
    epochs = [r for r in spans.records if r["label"] == "epoch"]
    epoch_ms = [r["start"].elapsed_time(r["stop"]) for r in epochs]
    steady = float(np.median(epoch_ms[1:]))
    log(f"  fit: {m.fit_stats_.wall_s:.3f} s wall (host clock, staging included), "
        f"{m.fit_stats_.examples_per_sec:.1f} examples/s; batch {B}, {steps} steps per epoch; "
        f"epoch ms (CUDA events): {json.dumps(epoch_ms)}; host ms to enqueue each epoch: "
        f"{json.dumps([r['host_ms'] for r in epochs])}")
    log(f"  steady epoch {steady:.3f} ms (median of epochs 2-{FIT_EPOCHS}) = {steady / steps:.4f} "
        f"ms a step = {qs.nnz / (steady / 1e3):.1f} examples/s")
    auc, p5 = fit_quality(m._state.user_table, m._state.item_table, qs)
    t0 = time.perf_counter()
    cpu = LightFM(loss="warp", no_components=FIT_D, random_state=seed, device="cpu")
    cpu.fit(coo, epochs=FIT_EPOCHS)
    cpu_s = time.perf_counter() - t0
    cpu_auc, cpu_p5 = fit_quality(cpu._state.user_table, cpu._state.item_table, qs)
    log(f"  train AUC / p@5: card {auc:.4f} / {p5:.4f}; the port's CPU fit at the same seed "
        f"{cpu_auc:.4f} / {cpu_p5:.4f} ({cpu_s:.3f} s wall)")
    check(auc > QS_AUC_FLOOR, f"quickstart train AUC {auc:.4f} > {QS_AUC_FLOOR}")
    check(abs(auc - cpu_auc) <= QS_CPU_BAND,
          f"quickstart AUC within {QS_CPU_BAND} of the CPU fit's ({abs(auc - cpu_auc):.4f})")
    check(finite(m._state), "quickstart state is finite")
    profiled_epoch(torch, train, m, seed)
    del cpu

    # (b) One epoch on the card and on the CPU with the same draws.
    log("  (b) one epoch, card against CPU, draws made on the CPU and copied to the card")
    W = table_width(FIT_D)
    w1 = np.ones(coo.nnz, np.float32)
    feats = (identity_rows(FIT_USERS), identity_rows(FIT_ITEMS))
    configs = [(loss, sched, 0.0) for loss in ("logistic", "warp", "bpr", "warp-kos")
               for sched in ("adagrad", "adadelta")]
    configs += [("warp", "adagrad", 1e-4), ("logistic", "adagrad", 1e-4)]
    same = {}
    for loss, sched, alpha in configs:
        name = f"{loss} {sched}" + (f" alpha={alpha:g}" if alpha else "")
        hp = Hyperparams(loss=loss, no_components=FIT_D, learning_schedule=sched,
                         item_alpha=alpha, user_alpha=alpha)
        rng = np.random.RandomState(seed + 21)
        arrays = {}
        for side, n in (("item", FIT_ITEMS), ("user", FIT_USERS)):
            t = np.zeros((n, W), np.float32)
            t[:, :FIT_D] = (rng.rand(n, FIT_D) - 0.5) / FIT_D
            arrays[f"{side}_table"] = t
            arrays[f"{side}_acc"] = np.full_like(t, 0.0 if sched == "adadelta" else 1.0)
            arrays[f"{side}_mom"] = np.zeros_like(t)
        arrays["item_log_scale"] = arrays["user_log_scale"] = np.float32(0.0)
        d_cpu = train.build_train_data(coo, w1, *feats, hp, B, "cpu")
        d_dev = train.build_train_data(coo, w1, *feats, hp, B, dev)
        draws = train.draw_generic_epoch(torch.Generator().manual_seed(seed + 3), d_cpu, hp, B)
        draws_dev = train.GenericDraws(*(x if x is None else x.to(dev) for x in draws))
        want = train.generic_epoch(interop.state_from_numpy(arrays, "cpu"), d_cpu, draws, hp, B)
        got, launches = counted_all(train.generic_epoch, interop.state_from_numpy(arrays, dev),
                                    d_dev, draws_dev, hp, B)
        step_kernels(f"card epoch {name}", launches, d_dev, d_dev.packed.shape[1] // B,
                     hp.adadelta)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        again = train.generic_epoch(interop.state_from_numpy(arrays, dev), d_dev, draws_dev, hp, B)
        stop.record()
        torch.cuda.synchronize()
        diff, excess = state_excess(got, want)
        check(excess <= 1e-5, f"{name}: card within 1e-5 + 1e-5|x| of the CPU (max |d| {diff:.3g})")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{name}: a second card epoch is bitwise equal to the first")
        moved = not torch.equal(got.item_table.cpu(), torch.from_numpy(arrays["item_table"]))
        check(finite(got) and moved, f"{name}: the epoch moved the tables and left them finite")
        same[name] = {"max_abs_diff": diff, "epoch_ms": start.elapsed_time(stop)}
    log("  card against CPU, one epoch (max |d| over the state; the repeat's CUDA-event ms): "
        + json.dumps(same))

    # (c) Feature layouts: hybrid logistic, and WARP over ChunkedRows.
    log("  (c) features: hybrid logistic (identity + tags), WARP over chunked rows")
    for name, kw, item_features in (
        ("logistic, identity + tags", dict(loss="logistic"), tag_features(FIT_ITEMS)),
        ("warp, chunked rows", dict(loss="warp"), heavy_features(FIT_ITEMS)),
    ):
        runs = []
        for _ in range(2):
            r = LightFM(no_components=FIT_D, random_state=seed, **kw)
            _, launches = counted_all(r.fit, coo, epochs=2, item_features=item_features)
            runs.append(r)
        step_kernels(f"fit {name} x2", launches, runs[1]._staged_train_data, fit_steps(runs[1], 2))
        check(runs[0]._staged_fast is False, f"{name}: the generic path")
        if name.startswith("warp"):
            f = runs[0]._staged_train_data.item_feats
            check(isinstance(f, ChunkedRows),
                  f"{name}: item features staged as ChunkedRows ({f.n_chunks} chunk(s) of "
                  f"{f.over_idx.shape[2]} over a base of {f.base.max_nnz})")
        check(finite(runs[0]._state), f"{name}: state is finite")
        check(all(torch.equal(a, b) for a, b in zip(runs[0]._state, runs[1]._state)),
              f"{name}: two same-seed 2-epoch fits are bitwise equal")
        log(f"  {name}: 2 epochs {runs[1].fit_stats_.wall_s:.3f} s wall (staging included)")

    # (d) The synth-5m-warp-d64 shape with fast_path="off".
    big = clustered_interactions(TRAIN_USERS, TRAIN_ITEMS, TRAIN_NNZ, seed)
    log(f"  (d) {TRAIN_USERS} x {TRAIN_ITEMS}, {big.nnz} interactions, D={D}, batch {TRAIN_BATCH}, "
        f"WARP, fast_path='off', {GENERIC_FULL_EPOCHS} epochs")
    m = LightFM(loss="warp", no_components=D, batch_size=TRAIN_BATCH, random_state=seed,
                fast_path="off")
    spans = Spans(torch)
    with spans.patch([(train, "_epoch", "epoch")]):
        torch.cuda.synchronize()
        _, launches = counted_all(m.fit, big, epochs=GENERIC_FULL_EPOCHS)
    torch.cuda.synchronize()
    step_kernels(f"fit warp x{GENERIC_FULL_EPOCHS} fast_path=off (5M)", launches,
                 m._staged_train_data, fit_steps(m, GENERIC_FULL_EPOCHS))
    check(m._staged_fast is False, "fast_path='off' took the generic path")
    check(finite(m._state), "the 5M generic fit's state is finite")
    big_steps = m._staged_train_data.packed.shape[1] // TRAIN_BATCH
    epochs = [r for r in spans.records if r["label"] == "epoch"]
    big_ms = [r["start"].elapsed_time(r["stop"]) for r in epochs]
    prof = profiled_epoch(torch, train, m, seed)
    per_step = prof.get("device_intervals", 0) / big_steps
    log(f"  generic epoch ms (CUDA events): {json.dumps(big_ms)}; host ms to enqueue each: "
        f"{json.dumps([r['host_ms'] for r in epochs])}; {big_steps} steps, "
        f"{per_step:.1f} device operations (kernels and copies) a step (profiled epoch)")
    log(f"  beside phase 5's fast epoch in this run: generic {big_ms[-1]:.3f} ms against fast "
        f"{fast['steady_ms']:.3f} ms (median); device busy {prof.get('busy_ms', float('nan')):.3f} "
        f"against {fast['profile'].get('busy_ms', float('nan')):.3f} ms, idle share "
        f"{prof.get('idle_share', float('nan')):.4f} against "
        f"{fast['profile'].get('idle_share', float('nan')):.4f}, device operations a step "
        f"{per_step:.1f} against "
        f"{fast['profile'].get('device_intervals', 0) / fast['steps']:.1f}")
    del m, big
    torch.cuda.empty_cache()

    # (e) Mid-fit checkpoints: a 4-epoch fit against 2 epochs, a reload, 2 more.
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(loss="warp", no_components=FIT_D, random_state=seed)
        full, launches = counted_all(LightFM(**kw).fit, coo, epochs=4, checkpoint_every_n_epochs=2,
                                     checkpoint_path=f"{tmp}/full.npz")
        step_kernels("checkpointed fit x4", launches, full._staged_train_data, fit_steps(full, 4))
        LightFM(**kw).fit(coo, epochs=2, checkpoint_every_n_epochs=2, checkpoint_path=f"{tmp}/part.npz")
        resumed = load_model(f"{tmp}/part.npz")
        check(resumed.device == str(torch.device(DEVICE)), f"load_model resumes on {resumed.device}")
        resumed.fit_partial(coo, epochs=2, checkpoint_every_n_epochs=2,
                            checkpoint_path=f"{tmp}/part.npz")
        check(all(torch.equal(a, b) for a, b in zip(resumed._state, full._state)),
              "a 2-epoch checkpoint resumed for 2 more equals the 4-epoch fit bitwise")
    log("  kernel launches by path (each counted from 0): " + json.dumps(path_launches))
    log(f"  phase 8 took {time.perf_counter() - t_phase:.1f} s")


# Data pipeline (phase 9): phase 6's data as a log of raw external ids,
# through the port's host side (Dataset on the native ingest engine,
# random_train_test_split) into phase 6's hybrid fit on the train split and
# an evaluation of the test split through the rank kernels.
TEST_AUC_FLOOR = 0.80  # 80% of draws in the user's cluster: ~0.8 x 0.99 + 0.2 x 0.5
PY_ROWS = 500_000  # the log's first rows, also run through the pure-Python path
EVAL_USERS = 2048
USER_BASE, ITEM_BASE, TAG_BASE, ID_STRIDE = 10**12, 2 * 10**12, 10**15, 7919


def external_ids(seed: int, n_users: int, n_items: int):
    """Injective int64 scrambles of the user and item indices, well away from
    0..n, and tag ids above every item id (item identity features and tags
    share one feature mapping, so a colliding tag would alias an item)."""
    rng = np.random.RandomState(seed + 9)
    users = USER_BASE + ID_STRIDE * rng.permutation(n_users).astype(np.int64)
    items = ITEM_BASE + ID_STRIDE * rng.permutation(n_items).astype(np.int64)
    return users, items, TAG_BASE + np.arange(N_TAGS, dtype=np.int64)


def back_map(mapping: dict, decode) -> np.ndarray:
    """``out[index] = decode(external id)`` over a ``Dataset`` mapping."""
    keys = np.fromiter(mapping.keys(), np.int64, len(mapping))
    index = np.fromiter(mapping.values(), np.int64, len(mapping))
    out = np.empty(len(mapping), np.int64)
    out[index] = decode(keys)
    return out


def same_entries(got, want) -> bool:
    """Equal shape, dtype, stored-entry count and every entry's value."""
    return (got.shape == want.shape and got.dtype == want.dtype and got.nnz == want.nnz
            and (sp.csr_matrix(got) != sp.csr_matrix(want)).nnz == 0)


def data_path(torch, seed: int) -> None:
    """Phase 9: raw ids -> ``Dataset`` -> split -> hybrid ``fit`` ->
    ``auc_score`` / ``precision_at_k`` on the card.  Stage times are the
    host clock of the machine that runs this script."""
    import glob
    import tempfile

    from lightfm_tpu_torch import LightFM, native, observability
    from lightfm_tpu_torch.cross_validation import random_train_test_split
    from lightfm_tpu_torch.data import Dataset
    from lightfm_tpu_torch.evaluation import auc_score, precision_at_k

    t_phase = time.perf_counter()
    secs = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        secs[name] = time.perf_counter() - t0
        return out

    coo = timed("reference data", clustered_interactions, TRAIN_USERS, TRAIN_ITEMS, TRAIN_NNZ, seed)
    feats_ref = tag_features(TRAIN_ITEMS)
    user_ext, item_ext, tag_ext = external_ids(seed, TRAIN_USERS, TRAIN_ITEMS)
    order = np.random.RandomState(seed + 10).permutation(coo.nnz)  # a log is not sorted
    u_log, i_log = user_ext[coo.row[order]], item_ext[coo.col[order]]
    w_log = coo.data[order]
    tag_coo = feats_ref[:, TRAIN_ITEMS:].tocoo()  # a tag drawn twice for an item holds 2
    times = tag_coo.data.astype(np.int64)
    f_items = item_ext[np.repeat(tag_coo.row, times)]  # the feature file: one row a draw
    f_tags = tag_ext[np.repeat(tag_coo.col, times)]
    log(f"phase 9: data pipeline, a log of {coo.nnz} (user, item, weight) rows with int64 "
        f"external ids over {TRAIN_USERS} users x {TRAIN_ITEMS} items, {f_items.size} "
        f"(item, tag) rows over {N_TAGS} tags (reference data made in "
        f"{secs['reference data']:.3f} s)")
    check(timed("native engine build", lambda: native.AVAILABLE),
          f"the port's native ingest engine is loaded ({native.target().name})")

    # (a) The native path at full size.
    engine = Spans(torch)
    with engine.patch([(native, "map_ids", "map_ids"), (native, "lookup_ids", "lookup_ids")]):
        ds = Dataset()
        timed("Dataset.fit", ds.fit, u_log, i_log, item_features=tag_ext)
        timed("Dataset.fit_partial (catalog)", ds.fit_partial, items=item_ext)
        inter, weights = timed("build_interactions", ds.build_interactions, (u_log, i_log, w_log))
        feats = timed("build_item_features normalize=False", ds.build_item_features,
                      (f_items, f_tags), normalize=False)
        feats_l1 = timed("build_item_features normalize=True", ds.build_item_features,
                         (f_items, f_tags), normalize=True)
        timed("identity block alone (normalize=False)", ds.build_item_features,
              (np.empty(0, np.int64), np.empty(0, np.int64)), normalize=False)
    calls = {k: sum(r["label"] == k for r in engine.records) for k in ("map_ids", "lookup_ids")}
    check(calls["map_ids"] >= 4 and calls["lookup_ids"] >= 6,
          f"Dataset took the native path ({json.dumps(calls)} engine calls)")
    umap, _, imap, fmap = ds.mapping()
    check(ds.interactions_shape() == coo.shape
          and ds.model_dimensions() == (TRAIN_USERS, feats_ref.shape[1]),
          f"mappings: {len(umap)} users, {len(imap)} items, {len(fmap)} item features")
    user_of = np.argsort(user_ext - USER_BASE)  # the scrambles' inverse permutations
    item_of = np.argsort(item_ext - ITEM_BASE)

    def item_index(k):
        return item_of[np.clip((k - ITEM_BASE) // ID_STRIDE, 0, TRAIN_ITEMS - 1)]

    back_u = back_map(umap, lambda k: user_of[(k - USER_BASE) // ID_STRIDE])
    back_i = back_map(imap, item_index)
    back_f = back_map(fmap, lambda k: np.where(k >= TAG_BASE, TRAIN_ITEMS + k - TAG_BASE,
                                               item_index(k)))

    def mapped_back(m, rows, cols):
        m = m.tocoo()
        return sp.coo_matrix((m.data, (rows[m.row], cols[m.col])), shape=m.shape)

    pattern = coo.copy()
    pattern.data = np.ones(coo.nnz, np.int32)
    check(same_entries(mapped_back(inter, back_u, back_i), pattern),
          "interactions, mapped back, equal phase 6's matrix entry for entry (int32 ones)")
    check(same_entries(mapped_back(weights, back_u, back_i), coo),
          "weights, mapped back, equal phase 6's matrix entry for entry (float32)")
    check(same_entries(mapped_back(feats, back_i, back_f), feats_ref),
          f"item features (normalize=False), mapped back, equal tag_features entry for entry "
          f"({feats.shape[0]} x {feats.shape[1]}, {feats.nnz} entries)")
    row_sums = np.asarray(feats_l1.sum(axis=1), np.float64).ravel()
    check(float(np.abs(row_sums - 1.0).max()) <= 1e-6,
          f"every row of the normalize=True features sums to 1 (worst |sum - 1| "
          f"{np.abs(row_sums - 1.0).max():.3g})")
    del row_sums, feats_l1

    # (b) The first PY_ROWS rows through the native and the pure-Python path.
    n = min(PY_ROWS, coo.nnz)

    def pipeline(users, items, tags, catalog, rows, feature_rows):
        d = Dataset()
        d.fit(users, items, item_features=tags)
        d.fit_partial(items=catalog)
        return d, d.build_interactions(rows), d.build_item_features(feature_rows, normalize=False)

    fast = timed(f"native path, first {n} rows", pipeline, u_log[:n], i_log[:n], tag_ext,
                 item_ext, (u_log[:n], i_log[:n], w_log[:n]), (f_items, f_tags))
    slow = timed(f"Python path, first {n} rows", pipeline, u_log[:n].tolist(), i_log[:n].tolist(),
                 tag_ext.tolist(), item_ext.tolist(),
                 list(zip(u_log[:n].tolist(), i_log[:n].tolist(), w_log[:n].tolist())),
                 [(e, [f]) for e, f in zip(f_items.tolist(), f_tags.tolist())])
    check(fast[0].mapping() == slow[0].mapping(), "native and Python paths give equal mappings")
    for what, a, b in (("interactions", fast[1][0], slow[1][0]), ("weights", fast[1][1], slow[1][1]),
                       ("item features", fast[2], slow[2])):
        a, b = a.tocoo(), b.tocoo()
        check(a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a.row, b.row)
              and np.array_equal(a.col, b.col) and np.array_equal(a.data, b.data),
              f"native and Python paths give equal {what} (row, col and value arrays)")
    del fast, slow

    # (c) Split, hybrid fit and evaluation on the card.
    train, test = timed("random_train_test_split", random_train_test_split, inter,
                        test_percentage=0.2, random_state=seed)
    check(train.nnz == int(0.8 * inter.nnz) and train.nnz + test.nnz == inter.nnz,
          f"split 80/20: {train.nnz} train, {test.nnz} test interactions")
    m = LightFM(loss="warp", no_components=D, batch_size=TRAIN_BATCH, random_state=seed)
    torch.cuda.synchronize()
    _, fit_launches = counted_all(timed, f"fit warp-hybrid x{HYBRID_EPOCHS}", m.fit, train,
                                  epochs=HYBRID_EPOCHS, item_features=feats)
    check(m._staged_fast == "einsum", "the fit took the hybrid fast path")
    check(fit_launches["sorted_adagrad_update"] > 0 and fit_launches["sorted_grad_sums"] > 0,
          f"the fit launched K1 ({fit_launches['sorted_adagrad_update']}) and K3 "
          f"({fit_launches['sorted_grad_sums']})")
    train_csr, test_csr = train.tocsr(), test.tocsr()
    auc_train = timed("train-sample AUC", auc_sample, m, train_csr, item_features=feats)
    check(auc_train >= HYBRID_AUC_FLOOR,
          f"train-sample AUC {auc_train:.4f} >= {HYBRID_AUC_FLOOR} after {HYBRID_EPOCHS} epochs")
    has_test = np.flatnonzero(np.diff(test_csr.indptr))
    users = np.random.RandomState(seed + 11).choice(has_test, min(EVAL_USERS, has_test.size),
                                                    replace=False)
    keep = np.zeros(test_csr.shape[0], np.float32)
    keep[users] = 1.0
    test_sub = sp.diags(keep).dot(test_csr).tocsr()
    test_sub.eliminate_zeros()

    def evaluate():
        auc = auc_score(m, test_sub, train_interactions=train_csr, item_features=feats)
        p5 = precision_at_k(m, test_sub, train_interactions=train_csr, k=5, item_features=feats)
        return float(auc.mean()), float(p5.mean()), auc.size

    (auc_test, p5_test, n_eval), eval_launches = counted_all(timed, "test auc_score + precision_at_k",
                                                             evaluate)
    log(f"  test split, {n_eval} sampled users ({test_sub.nnz} test interactions, train "
        f"interactions excluded): AUC {auc_test:.4f}, precision@5 {p5_test:.4f}")
    check(auc_test >= TEST_AUC_FLOOR, f"test AUC {auc_test:.4f} >= {TEST_AUC_FLOOR}")
    check(eval_launches["rank_counts"] > 0 and eval_launches["pair_scores"] > 0,
          f"the evaluation launched rank_counts ({eval_launches['rank_counts']}) and "
          f"pair_scores ({eval_launches['pair_scores']})")

    # (d) One more epoch untraced, then one under observability.trace, whose
    # torch.profiler trace must name K1's and K3's kernels.
    timed("fit_partial x1", m.fit_partial, train, epochs=1, item_features=feats)
    with tempfile.TemporaryDirectory() as tmp:
        def traced_epoch():
            with observability.trace(tmp):
                timed("fit_partial x1 under the profiler", m.fit_partial, train, epochs=1,
                      item_features=feats)
                t_stop = time.perf_counter()
            secs["profiler stop + trace written"] = time.perf_counter() - t_stop

        _, trace_launches = counted_all(traced_epoch)
        paths = glob.glob(f"{tmp}/*.pt.trace.json")
        check(len(paths) == 1, "the trace was written as one *.pt.trace.json")
        log(f"  trace: {os.path.basename(paths[0])}, {os.path.getsize(paths[0]) / 1e6:.1f} MB")
        with open(paths[0]) as fh:
            events = json.load(fh)["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        named = {k: sum(k in name for name in kernels)
                 for k in ("adagrad_segment_pass", "grad_sums_segment_pass")}
        check(all(v > 0 for v in named.values()),
              f"the trace parses and holds {len(kernels)} CUDA kernel events, K1's and K3's "
              f"among them ({json.dumps(named)})")
    log("  kernel launches by path (each counted from 0): " + json.dumps({
        f"data path: fit warp-hybrid x{HYBRID_EPOCHS}": fit_launches,
        "data path: test auc_score + precision_at_k": eval_launches,
        "data path: traced epoch": trace_launches}))
    check(bool(torch.isfinite(m._state.item_table).all()), "the tables are finite")
    del m
    torch.cuda.empty_cache()
    secs["phase 9"] = time.perf_counter() - t_phase
    log("  phase 9 host seconds by stage: " + json.dumps(secs))


# Phase 10: multi-device, in child processes (a process group lives in them
# only).  (a) one NCCL rank; (b) two gloo ranks, each on its own card where
# the machine has two (rank_card), else sharing cuda:0.  Correctness only:
# gloo moves every collective through the host over loopback; phase 12
# runs NCCL across cards.
MESH_NCCL_EPOCHS = 2
MESH_GLOO_EPOCHS = 3
MESH_AUC_BAND = 0.005  # (b): train-sample AUC against the one-device fit
MESH_STEP_RTOL, MESH_STEP_ATOL = 2e-5, 2e-6  # tests/test_torch_parallel_fast.py
MESH_STATE_SHARE = 0.99  # (b): share of entries within that bound after 3 epochs
MESH_REC_USERS = 2048
MESH_CHILD_TIMEOUT_S = 480
MESH_PG_TIMEOUT_S = 300
RANK_GRACE_S = 15  # after a rank fails, how long the others may take to fail too


def rank_card(rank: int, n_cards: int) -> int:
    """The card a child rank of this script sits on (``LOCAL_RANK``): its
    own where the machine has a card a rank, else the cards in turn (gloo
    ranks only: NCCL refuses two ranks on one card)."""
    return rank % n_cards


def _where(world: int, n_cards: int) -> str:
    """How ``world`` child ranks sit on this machine's cards, for the logs."""
    cards = [rank_card(r, n_cards) for r in range(world)]
    if len(set(cards)) == 1:
        return f"sharing cuda:{cards[0]}"
    return "on " + ", ".join(f"cuda:{c}" for c in cards)


class CollectiveClock:
    """CUDA events on the current stream around every call of
    ``parallel.mesh._collective`` in this process, with the bytes of the
    rank's block.  Under NCCL the collective runs on NCCL's own stream,
    which waits for the current stream before it starts, and the current
    stream waits for it after, so the events hold its device time (with
    any wait for a slower peer); ``Mesh.stats`` seconds are only the host's
    enqueue there."""

    def __init__(self, torch):
        from lightfm_tpu_torch.parallel import mesh as pmesh

        self.torch, self.calls = torch, []
        real = pmesh._collective

        def timed(mesh, block, op):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(mesh, block, op)
            stop.record()
            self.calls.append((isinstance(out, list) and len(out), block.numel() * block.element_size(),
                               start, stop))
            return out

        pmesh._collective = timed

    def take(self) -> dict:
        """The calls since the last ``take``, by kind: calls, MB of the
        rank's blocks, device ms (summed and the median call), and bus
        GB/s, NCCL's measure: an all-gather of n blocks moves (n - 1)
        blocks into each rank, a broadcast one; over all the calls (waits
        for a slower rank included), and the median call's."""
        self.torch.cuda.synchronize()
        kinds = {}
        for n, size, start, stop in self.calls:
            kind = "all_gather" if n else "broadcast"
            r = kinds.setdefault(kind, {"calls": 0, "block_mb": 0.0, "bus_mb": 0.0, "ms": [],
                                        "rates": []})
            ms, bus_mb = start.elapsed_time(stop), (n - 1 if n else 1) * size / 1e6
            r["calls"] += 1
            r["block_mb"] += size / 1e6
            r["bus_mb"] += bus_mb
            r["ms"].append(ms)
            r["rates"].append(bus_mb / ms if ms > 0 else 0.0)  # MB/ms
        self.calls = []
        for r in kinds.values():
            times, r["ms"] = r["ms"], float(sum(r["ms"]))
            r["median_ms"] = float(np.median(times))
            r["bus_gb_s"] = r["bus_mb"] / r["ms"] if r["ms"] > 0 else None
            r["median_bus_gb_s"] = float(np.median(r.pop("rates")))
        return kinds


_CLOCK = None  # a child's CollectiveClock (mesh_rank_main)


def _collectives() -> dict:
    """The child's collectives since the last call (``CollectiveClock.take``)."""
    return _CLOCK.take() if _CLOCK is not None else {}


def _card_words(kinds: dict) -> str:
    return "; ".join(
        f"{kind} {r['calls']} calls, {r['block_mb']:.3f} MB of blocks, {r['ms']:.3f} ms "
        f"(median {r['median_ms']:.4f}), bus {r['bus_gb_s'] or 0:.2f} GB/s (median call "
        f"{r['median_bus_gb_s']:.2f})"
        for kind, r in sorted(kinds.items())) or "none"


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _digests(state) -> dict:
    import hashlib

    return {name: hashlib.sha256(x.detach().contiguous().cpu().numpy().tobytes()).hexdigest()
            for name, x in zip(type(state)._fields, state)}


def _within(torch, got, want, rtol: float, atol: float):
    """Share of the entries of the four tables and accumulators within
    ``atol + rtol * |want|``, and the largest ``|got - want|``."""
    inside, total, worst = 0, 0, 0.0
    for name in ("item_table", "item_acc", "user_table", "user_acc"):
        g, w = getattr(got, name), getattr(want, name)
        d = (g - w).abs()
        inside += int((d <= atol + rtol * w.abs()).sum())
        total += d.numel()
        worst = max(worst, float(d.max()))
    return inside / total, worst


def _mesh_fit(torch, model, mesh, coo, epochs: int, **fit_kw):
    """``model.fit`` over ``mesh`` with the launch counts from 0 and CUDA
    events around each epoch; the collectives' host-clock time and bytes
    per step, and their device times (``CollectiveClock``, placement's
    broadcasts included)."""
    from lightfm_tpu_torch import train

    spans = Spans(torch)
    mesh.reset_stats()
    _collectives()
    with spans.patch([(train, "_epoch", "epoch")]):
        torch.cuda.synchronize()
        _, launches = counted_all(model.fit, coo, epochs=epochs, **fit_kw)
    torch.cuda.synchronize()
    device = _collectives()
    steps = model._staged_train_data.packed.shape[1] * (
        mesh.shape["data"] if model._staged_train_data.examples_sharded else 1
    ) // model._staged_batch_size * epochs
    return {
        "epoch_ms": [r["start"].elapsed_time(r["stop"]) for r in spans.records],
        "collective_ms_per_step": mesh.stats["seconds"] * 1e3 / steps,
        "collective_calls_per_step": mesh.stats["calls"] / steps,
        "bytes_per_step": mesh.stats["bytes"] / steps,
        "steps": steps, "launches": launches, "collectives": device,
    }


def mesh_nccl_rank(torch, seed: int, rank: int, out_dir: str) -> dict:
    """(a) One NCCL rank, ``make_mesh(n_data=1)``: the data-parallel fast
    path at the 5M shape through K1, bitwise the fit without a mesh;
    ``recommend`` through ``top_k_sharded`` against ``top_k``."""
    from lightfm_tpu_torch import LightFM
    from lightfm_tpu_torch.parallel import make_mesh

    mesh = make_mesh(n_data=1)
    _check_card(torch, mesh, rank)
    coo = clustered_interactions(TRAIN_USERS, TRAIN_ITEMS, TRAIN_NNZ, seed)

    def model(**kw):
        return LightFM(loss="warp", no_components=D, batch_size=TRAIN_BATCH, random_state=seed,
                       **kw)

    m = model(mesh=mesh)
    out = _mesh_fit(torch, m, mesh, coo, MESH_NCCL_EPOCHS)
    check(m._staged_fast == "einsum", "the mesh fit took the data-parallel fast path")
    k1 = out["launches"]["sorted_adagrad_update"]
    check(k1 == 2 * out["steps"], f"K1 launched 2 x {out['steps']} steps = {k1} times on the mesh")
    plain = model().fit(coo, epochs=MESH_NCCL_EPOCHS)
    check(all(torch.equal(a, b) for a, b in zip(m._state, plain._state)),
          "the one-rank NCCL mesh fit is bitwise the fit without a mesh")
    users = np.arange(0, TRAIN_USERS, TRAIN_USERS // MESH_REC_USERS)
    s_mesh, i_mesh = m.recommend(users, k=10)
    s_one, i_one = plain.recommend(users, k=10)
    check(np.array_equal(i_mesh, i_one), "recommend through top_k_sharded returns top_k's ids")
    err = float(np.abs(s_mesh - s_one).max())
    check(err <= 1e-6, f"and its scores (max |d| {err:.3g}, bitwise {np.array_equal(s_mesh, s_one)})")
    out.update(rec_max_abs_err=err, rec_bitwise=bool(np.array_equal(s_mesh, s_one)))
    return out


def mesh_gloo_rank(torch, seed: int, rank: int, out_dir: str) -> dict:
    """(b) Two gloo ranks (``_where``), ``make_mesh(n_data=2)``: the 5M
    fit of 3 epochs (a rank's slice 65,536 examples, 4 pools), replicas
    bitwise equal, one step within the CPU tests' bound of the one-device
    step, the fit's train-sample AUC within MESH_AUC_BAND of the one-device
    fit's; then at the quickstart size one generic epoch against one
    device, an example-sharded fit with the local shuffle, and
    ``recommend`` over a (1, 2) mesh."""
    from lightfm_tpu_torch import LightFM, fast_warp as fw
    from lightfm_tpu_torch.parallel import make_mesh
    from lightfm_tpu_torch.parallel.mesh import barrier
    from lightfm_tpu_torch.state import ModelState

    mesh = make_mesh(n_data=2)
    _check_card(torch, mesh, rank)
    coo = clustered_interactions(TRAIN_USERS, TRAIN_ITEMS, TRAIN_NNZ, seed)
    csr = coo.tocsr()

    def model(**kw):
        return LightFM(loss="warp", no_components=D, batch_size=TRAIN_BATCH, random_state=seed,
                       fast_precision="highest", **kw)

    m = model(mesh=mesh)
    out = _mesh_fit(torch, m, mesh, coo, MESH_GLOO_EPOCHS)
    check(m._staged_fast == "einsum", "the mesh fit took the data-parallel fast path")
    k1 = out["launches"]["sorted_adagrad_update"]
    check(k1 == 2 * out["steps"], f"K1 launched 2 x {out['steps']} steps = {k1} times on rank {rank}")
    out["digests"] = _digests(m._state)
    out["auc"] = auc_sample(m, csr)

    # One step from the fitted state: the mesh step against the one-device step.
    data, hp, B = m._staged_train_data, m._staged_hp, m._staged_batch_size
    gen = torch.Generator(device=mesh.device).manual_seed(seed + 5)
    draws = fw.draw_epoch(gen, data, hp, B)
    shuffled, suid, sigma = fw.shuffle_item_sorted(
        data.packed, draws.perm, data.packed.shape[1] // B, B, hp.shuffle_mode)
    half = B // 2

    def step(on_mesh):
        state = ModelState(*(x.clone() for x in m._state))
        cols = slice(rank * half, (rank + 1) * half) if on_mesh else slice(None)
        fw.warp_pool_step(state, fw._unpack_batch5(shuffled[0][:, cols]), data.positives,
                          suid[0], sigma[0], hp, draws.pool[0], draws.shifts[0],
                          n_items=TRAIN_ITEMS, user_pallas=True, mesh=mesh if on_mesh else None)
        return state

    share, worst = _within(torch, step(True), step(False), MESH_STEP_RTOL, MESH_STEP_ATOL)
    check(share == 1.0, f"one mesh step within {MESH_STEP_ATOL:g} + {MESH_STEP_RTOL:g}|x| of the "
          f"one-device step (max |d| {worst:.3g})")
    out["step_max_abs_err"] = worst
    if rank == 0:
        plain = model().fit(coo, epochs=MESH_GLOO_EPOCHS)
        share, worst = _within(torch, m._state, plain._state, MESH_STEP_RTOL, MESH_STEP_ATOL)
        out.update(state_share=share, state_max_abs_err=worst, plain_auc=auc_sample(plain, csr))
        del plain
    del m
    torch.cuda.empty_cache()
    barrier(mesh)

    # The quickstart size: generic path, local shuffle, recommend over (1, 2).
    qs = planted_ml100k(seed)
    qcoo = qs.tocoo()

    def quick(**kw):
        return LightFM(loss="warp", no_components=FIT_D, random_state=seed, **kw)

    g = quick(mesh=mesh, fast_path="off")
    out["generic"] = _mesh_fit(torch, g, mesh, qcoo, 1)
    check(g._staged_fast is False, "the quickstart mesh fit took the generic path")
    one = quick(fast_path="off").fit(qcoo, epochs=1)
    share, worst = _within(torch, g._state, one._state, MESH_STEP_RTOL, MESH_STEP_ATOL)
    check(share == 1.0, f"one generic epoch over the mesh within the bound of one device "
          f"(max |d| {worst:.3g}, bitwise {all(torch.equal(a, b) for a, b in zip(g._state, one._state))})")
    out["generic_digests"] = _digests(g._state)
    loc = quick(mesh=mesh, shard_examples=True, example_shuffle="local")
    out["local"] = _mesh_fit(torch, loc, mesh, qcoo, FIT_EPOCHS)
    auc, p5 = fit_quality(loc._state.user_table, loc._state.item_table, qs)
    check(auc > QS_AUC_FLOOR, f"the example-sharded, locally shuffled fit: train AUC {auc:.4f} > "
          f"{QS_AUC_FLOOR} (p@5 {p5:.4f})")
    out.update(local_auc=auc, local_digests=_digests(loc._state))
    mesh_12 = make_mesh(n_data=1, n_model=2)
    one.mesh = mesh_12
    s_mesh, i_mesh = one.recommend(np.arange(FIT_USERS), k=10, train_interactions=qs)
    one.mesh = None
    s_one, i_one = one.recommend(np.arange(FIT_USERS), k=10, train_interactions=qs)
    check(np.array_equal(i_mesh, i_one), "recommend over a (1, 2) mesh returns top_k's ids")
    err = float(np.abs(s_mesh - s_one).max())
    check(err <= 1e-6, f"and its scores (max |d| {err:.3g})")
    out["rec_max_abs_err"] = err
    return out


def mesh_rank_main(torch, args) -> int:
    """A child of phase 10, 11 or 12: bind its card, join the process group,
    run this rank's part with its collectives timed, write its record,
    leave the group."""
    import torch.distributed as dist

    from lightfm_tpu_torch.parallel import initialize_multihost

    global _CLOCK
    card = rank_card(args.rank, torch.cuda.device_count())
    if args.mesh_rank == "gloo":  # initialize_multihost binds NCCL ranks only
        torch.cuda.set_device(card)
    initialize_multihost(backend=args.mesh_rank, init_method=f"tcp://localhost:{args.port}",
                         world_size=args.world, rank=args.rank, timeout_s=args.pg_timeout)
    try:
        check(torch.cuda.current_device() == card,
              f"{args.mesh_rank} rank {args.rank} is bound to cuda:{card}")
        _CLOCK = CollectiveClock(torch)
        part = {"mesh": mesh_nccl_rank if args.mesh_rank == "nccl" else mesh_gloo_rank,
                "split": split_rank, "split22": split22_rank, "cards": cards_rank}[args.part]
        out = part(torch, args.seed, args.rank, args.out)
        with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


def run_ranks(torch, backend: str, world: int, seed: int, out_dir: str, part: str = "mesh",
              timeout_s: float = MESH_CHILD_TIMEOUT_S,
              pg_timeout_s: float = MESH_PG_TIMEOUT_S) -> list:
    """Start ``world`` ranks of this script as children running ``part``
    (``mesh``: phase 10's; ``split``, ``split22``: phase 11's and 12's;
    ``cards``: phase 12's), rank r on ``cuda:rank_card(r)`` (its
    ``LOCAL_RANK``), each with its output in ``out_dir``; wait for them with
    a deadline, and once one fails, ``RANK_GRACE_S`` for the rest (then
    kill every one still running: an NCCL rank may wait on a dead peer
    until its group's timeout); log their output, and return their
    records.  A child that fails fails the phase."""
    n_cards = torch.cuda.device_count()
    cmd = [sys.executable, os.path.abspath(__file__), "--seed", str(seed), "--mesh-rank", backend,
           "--world", str(world), "--port", str(_free_port()), "--out", out_dir, "--part", part,
           "--pg-timeout", str(pg_timeout_s)]
    procs, paths = [], []
    for r in range(world):
        env = {**os.environ, "LOCAL_RANK": str(rank_card(r, n_cards))}
        if backend == "nccl":
            env.setdefault("NCCL_DEBUG", "WARN")
        paths.append(os.path.join(out_dir, f"rank{r}.log"))
        with open(paths[-1], "w") as fh:
            procs.append(subprocess.Popen(cmd + ["--rank", str(r)], env=env, stdout=fh,
                                          stderr=subprocess.STDOUT,
                                          cwd=os.path.dirname(os.path.abspath(__file__))))
    deadline, failed_at = time.monotonic() + timeout_s, None
    try:
        while None in [p.poll() for p in procs]:  # every child polled, each round
            now = time.monotonic()
            if failed_at is None and any(p.returncode not in (None, 0) for p in procs):
                failed_at = now
            if now > deadline or (failed_at is not None and now > failed_at + RANK_GRACE_S):
                break
            time.sleep(0.1)
    finally:
        running = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, path in enumerate(paths):
        with open(path) as fh:
            for line in fh.read().splitlines():
                log(f"    [{part} {backend} rank {r}] {line}")
    if running and failed_at is None:
        raise AssertionError(f"{part} ({backend}): rank(s) {running} outlived {timeout_s} s")
    check(all(p.returncode == 0 for p in procs),
          f"{part} {backend}: {world} rank(s) exited 0 ({[p.returncode for p in procs]}"
          f"{'; killed after a rank failed: ' + str(running) if running else ''})")
    outs = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    return outs


def mesh_path(torch, seed: int) -> dict:
    """Phase 10: multi-device over ``torch.distributed``, in child processes
    (the main process never holds a process group).  Returns the launch
    counts of each mesh path, from each child's own counts."""
    import tempfile

    from lightfm_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    _build.build_all()  # built by phase 1; the children only load the libraries
    torch.cuda.empty_cache()
    log(f"phase 10: multi-device. (a) one NCCL rank, (b) two gloo ranks "
        f"{_where(2, torch.cuda.device_count())}; {TRAIN_USERS} users x {TRAIN_ITEMS} items, "
        f"D={D}, batch {TRAIN_BATCH}")
    card = nvidia_smi("name,power.limit")
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "a"))
        os.makedirs(os.path.join(tmp, "b"))
        t0 = time.perf_counter()
        (a,) = run_ranks(torch, "nccl", 1, seed, os.path.join(tmp, "a"))
        secs_a = time.perf_counter() - t0
        t0 = time.perf_counter()
        b = run_ranks(torch, "gloo", 2, seed, os.path.join(tmp, "b"))
        secs_b = time.perf_counter() - t0
    log(f"  (a) NCCL, 1 rank ({card}): epoch ms (CUDA events) {json.dumps(a['epoch_ms'])}; "
        f"host enqueue of its collectives {a['collective_ms_per_step']:.4f} ms a step (host "
        f"clock; NCCL runs them asynchronously, so this is not their time), "
        f"{a['bytes_per_step'] / 1e6:.3f} MB sent a step; recommend bitwise {a['rec_bitwise']}")
    for r, rec in enumerate(b):
        log(f"  (b) gloo rank {r} ({card}; gloo moves every collective through the host over "
            f"loopback, so these times say nothing about NCCL over NVLink): epoch ms (CUDA "
            f"events) {json.dumps(rec['epoch_ms'])}; collectives "
            f"{rec['collective_ms_per_step']:.3f} ms a step (host clock), "
            f"{rec['collective_calls_per_step']:.1f} calls, {rec['bytes_per_step'] / 1e6:.3f} MB "
            f"sent a step; quickstart generic "
            f"epoch ms {json.dumps(rec['generic']['epoch_ms'])}, local-shuffle fit "
            f"{FIT_EPOCHS} epochs median "
            f"{float(np.median(rec['local']['epoch_ms'])):.3f} ms, collectives "
            f"{rec['local']['collective_ms_per_step']:.3f} ms a step")
    r0, r1 = b
    for key in ("digests", "generic_digests", "local_digests"):
        check(r0[key] == r1[key], f"(b) the two ranks' {key.replace('_', ' ')} are bitwise equal")
    check(r0["auc"] == r1["auc"], f"(b) both replicas read train-sample AUC {r0['auc']:.4f}")
    check(abs(r0["auc"] - r0["plain_auc"]) <= MESH_AUC_BAND,
          f"(b) within {MESH_AUC_BAND} of the one-device fit's {r0['plain_auc']:.4f}")
    check(r0["state_share"] >= MESH_STATE_SHARE,
          f"(b) after {MESH_GLOO_EPOCHS} epochs {r0['state_share']:.6f} of the state's entries "
          f"lie within the one-step bound of the one-device fit (>= {MESH_STATE_SHARE}; max |d| "
          f"{r0['state_max_abs_err']:.3g})")
    secs = time.perf_counter() - t_phase
    log(f"  phase 10: {secs:.1f} s ((a) {secs_a:.1f}, (b) {secs_b:.1f}, child start-up included)")
    return {
        "mesh nccl x1 rank fit warp": a["launches"],
        **{f"mesh gloo rank {r} fit warp": rec["launches"] for r, rec in enumerate(b)},
        **{f"mesh gloo rank {r} quickstart local-shuffle fit": rec["local"]["launches"]
           for r, rec in enumerate(b)},
    }


# Phase 11: row and component table partitions, in child processes as phase
# 10.  (a), (b): two gloo ranks, a (1, 2) mesh at synth-5m-warp-d64's
# widths; (c) four gloo ranks, a (2, 2) mesh at the quickstart size; each
# rank on its own card where the machine has enough, else sharing them.
# Gloo shows correctness and bytes, not NVLink speed; phase 12 runs the
# same parts under NCCL across cards.
SPLIT_STEPS = 4  # depth cut: one epoch of 4 x TRAIN_BATCH interactions
SPLIT_RANK_USERS = 2048
SPLIT_CKPT_EVERY = 10


def split_interactions(seed: int):
    """``SPLIT_STEPS`` batches of phase 5's clustered set, drawn from it at
    random (its COO is sorted by user, so its first entries would touch
    only the first tenth of the user table)."""
    coo = clustered_interactions(TRAIN_USERS, TRAIN_ITEMS, TRAIN_NNZ, seed)
    keep = np.sort(np.random.RandomState(seed).choice(coo.nnz, SPLIT_STEPS * TRAIN_BATCH,
                                                      replace=False))
    return sp.coo_matrix((coo.data[keep], (coo.row[keep], coo.col[keep])), shape=coo.shape)


def _state_bytes(state) -> int:
    return sum(x.numel() * x.element_size() for x in state)


def _fit_peaks(torch, fit, *args, **kwargs):
    """``fit(*args, **kwargs)`` and the card's peak bytes above what the
    process held before it: up to the first epoch (initial state, its
    placement, the staged data) and over the epochs."""
    from lightfm_tpu_torch import train

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    peaks, real = {}, train.run_epochs

    def run(*a, **kw):
        torch.cuda.synchronize()
        peaks["placed"] = torch.cuda.max_memory_allocated() - held
        torch.cuda.reset_peak_memory_stats()
        return real(*a, **kw)

    train.run_epochs = run
    try:
        out = fit(*args, **kwargs)
    finally:
        train.run_epochs = real
    torch.cuda.synchronize()
    peaks["fit"] = torch.cuda.max_memory_allocated() - held
    return out, peaks


def record_assemble() -> list:
    """From now on in this process, the fields of each call of
    ``parallel.mesh.assemble``, one tuple a call."""
    from lightfm_tpu_torch.parallel import mesh as pmesh

    asked, real = [], pmesh.assemble

    def assemble(state, placement, fields, device=None):
        asked.append(tuple(fields))
        return real(state, placement, fields, device)

    pmesh.assemble = assemble
    return asked


def split_rank(torch, seed: int, rank: int, out_dir: str) -> dict:
    """(a), (b) n ranks (phase 11: two gloo ranks; phase 12: NCCL, one a
    card), ``make_mesh(n_data=1, n_model=n)``: one generic epoch at full
    width with the tables split by rows, then by components; each rank
    holds 1/n of each table, the
    assembled state is the one-device ``fast_path="off"`` fit's (bitwise
    expected), ``predict_rank`` for 2,048 users goes through K2 and
    ``pair_scores`` and equals the one-device model's, ``recommend`` over
    the mesh returns bitwise what a replicated-table model on the same mesh
    with the same state returns, and ``predict`` equals the one-device
    model's.  No serving call assembles the user table, and under rows
    ``recommend`` and ``predict`` assemble nothing.  Logs each rank's peak
    bytes on the card while placing and fitting, and for each serving call
    its peak bytes, the bytes it sent and its collectives' device times."""
    import pickle

    import torch.distributed as dist

    from lightfm_tpu_torch import LightFM
    from lightfm_tpu_torch.state import ModelState, table_width

    asked = record_assemble()
    n = dist.get_world_size()
    mesh = _card_mesh(torch, rank, n_data=1, n_model=n)
    coo = split_interactions(seed)
    csr = coo.tocsr()
    users = np.random.RandomState(seed + 1).choice(TRAIN_USERS, SPLIT_RANK_USERS, replace=False)
    keep = np.zeros(TRAIN_USERS, np.float32)
    keep[users] = 1.0
    test = sp.diags(keep).dot(csr).tocsr()
    test.eliminate_zeros()
    rec_users = np.arange(0, TRAIN_USERS, TRAIN_USERS // MESH_REC_USERS)

    def model(**kw):
        return LightFM(loss="warp", no_components=D, batch_size=TRAIN_BATCH, random_state=seed,
                       **kw)

    one = None
    out = {}
    if rank == 0:
        one, out["one_peaks"] = _fit_peaks(torch, model(fast_path="off").fit, coo, epochs=1)
        one_ranks = one.predict_rank(test, check_intersections=False).data
        one_s, one_rec = one.recommend(rec_users, k=10)
        one_host = ModelState(*(x.cpu() for x in one._state))
    W = table_width(D)
    for partition, item_part, user_part in (
        ("rows", (TRAIN_ITEMS // n, W), (TRAIN_USERS // n, W)),
        ("components", (TRAIN_ITEMS, W // n), (TRAIN_USERS, W // n)),
    ):
        m = model(mesh=mesh, table_partition=partition)
        rec, peaks = _fit_peaks(torch, _mesh_fit, torch, m, mesh, coo, 1)
        rec["peaks"] = peaks
        check(m._staged_fast is False, f"{partition}: the split fit took the generic path")
        check((tuple(m._state.item_table.shape), tuple(m._state.user_table.shape))
              == (item_part, user_part),
              f"{partition}: rank {rank} holds item {item_part} and user {user_part}")
        rec["state_bytes"] = _state_bytes(m._state)
        whole = m._whole_state()  # on the host
        rec["whole_bytes"] = _state_bytes(whole)
        rec["digests"] = _digests(whole)
        rec["serve"] = {}
        t_serve = time.perf_counter()

        def serve(name, fn, *args, **kwargs):
            """``fn(*args, **kwargs)`` on the split model from a cold serving
            cache, recording the rank's peak bytes above its prior
            allocation, the bytes it sent, its collectives, host-clock
            seconds, launches and the fields it asked ``assemble`` for."""
            m._drop_state_dependent_cache()
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            mesh.reset_stats()
            _collectives()
            n0 = len(asked)
            t0 = time.perf_counter()
            result, launches = counted_all(fn, *args, **kwargs)
            torch.cuda.synchronize()
            fields = sorted({f for call in asked[n0:] for f in call})
            rec["serve"][name] = {
                "peak": torch.cuda.max_memory_allocated() - held, "sent": mesh.stats["bytes"],
                "collectives": mesh.stats["calls"], "s": time.perf_counter() - t0,
                "asked": fields, "device": _collectives(),
                "launches": {k: launches[k] for k in ("rank_counts", "pair_scores")},
            }
            check("user_table" not in fields, f"{partition}: {name} on the split model "
                  f"assembles no user table (it asked for {fields})")
            return result

        ranks = serve("predict_rank", m.predict_rank, test, check_intersections=False)
        launches = rec["predict_rank_launches"] = rec["serve"]["predict_rank"]["launches"]
        check(launches["rank_counts"] > 0 and launches["pair_scores"] > 0,
              f"{partition}: predict_rank on the split model launched K2 "
              f"{launches['rank_counts']} and pair_scores {launches['pair_scores']} times")
        scores, ids = serve("recommend", m.recommend, rec_users, k=10)
        pairs = (np.repeat(rec_users, 10), ids.ravel())
        pred = serve("predict", m.predict, *pairs)
        check(rec["serve"]["predict"]["asked"] == [], f"{partition}: predict assembles nothing")
        if partition == "rows":
            check(rec["serve"]["recommend"]["asked"] == [],
                  "rows: recommend assembles nothing (each rank scores its own item rows)")
        # The same state with replicated tables on the same mesh: both serve
        # through top_k_sharded, so the split tables must change nothing.
        rep = pickle.loads(pickle.dumps(m))
        rep.mesh = mesh
        rep_s, rep_ids = rep.recommend(rec_users, k=10)
        check(np.array_equal(ids, rep_ids) and np.array_equal(scores, rep_s),
              f"{partition}: recommend on the split model is bitwise that of the "
              "replicated-table model on the same mesh")
        del rep
        rec["serve_s"] = time.perf_counter() - t_serve
        if rank == 0:
            share, worst = _within(torch, whole, one_host, MESH_STEP_RTOL, MESH_STEP_ATOL)
            bitwise = all(torch.equal(a, b) for a, b in zip(whole, one_host))
            check(share == 1.0, f"{partition}: the assembled state within {MESH_STEP_ATOL:g} + "
                  f"{MESH_STEP_RTOL:g}|x| of the one-device fit (max |d| {worst:.3g}, bitwise "
                  f"{bitwise})")
            # The adagrad kernel sums a row's touches in an order set by
            # that row's own touches alone, whatever the partition.
            check(bitwise, f"{partition}: the assembled state is bitwise the one-device fit's")
            rec.update(max_abs_err=worst, bitwise=bitwise)
            check(np.array_equal(ranks.data, one_ranks),
                  f"{partition}: predict_rank for {SPLIT_RANK_USERS} users equals the one-device "
                  f"model's ({ranks.nnz} ranks)")
            # The mesh scores each half of the catalog in its own product, the
            # one-device model the whole: cuBLAS may pick kernels that sum
            # the 73 terms in another order, so near-ties may swap.  The
            # mesh's ids must be a top 10 by the one-device model's scores.
            own = one.predict(*pairs)
            check(np.array_equal(pred, own), f"{partition}: predict of {len(own)} pairs on the "
                  "split model equals the one-device model's")
            own = own.reshape(ids.shape)
            err = max(float(np.abs(scores - one_s).max()), float(np.abs(own - one_s).max()))
            same = float((ids == one_rec).all(axis=1).mean())
            check(err <= 1e-5 + 1e-5 * float(np.abs(one_s).max()),
                  f"{partition}: recommend over the mesh returns a top 10 of the one-device "
                  f"model (max |d| of scores {err:.3g}; ids identical for {same:.4f} of "
                  f"{len(rec_users)} users)")
            rec.update(rec_max_abs_err=err, rec_same_ids=same)
        out[partition] = rec
        del m, whole
        torch.cuda.empty_cache()
    return out


def split22_rank(torch, seed: int, rank: int, out_dir: str) -> dict:
    """(c) Four ranks (phase 11: gloo; phase 12: NCCL, one a card),
    ``make_mesh(n_data=2, n_model=2)``, at the quickstart size: rows,
    example-sharded input, the local shuffle, FIT_EPOCHS epochs with a
    checkpoint every SPLIT_CKPT_EVERY; the 943-row user table warns and
    stays whole, the item table splits 841 / 841, the fit trains."""
    import warnings

    from lightfm_tpu_torch import LightFM
    from lightfm_tpu_torch.state import table_width

    mesh = _card_mesh(torch, rank, n_data=2, n_model=2)
    qs = planted_ml100k(seed)
    m = LightFM(loss="warp", no_components=FIT_D, random_state=seed, mesh=mesh,
                table_partition="rows", shard_examples=True, example_shuffle="local")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = _mesh_fit(torch, m, mesh, qs.tocoo(), FIT_EPOCHS,
                        checkpoint_every_n_epochs=SPLIT_CKPT_EVERY,
                        checkpoint_path=os.path.join(out_dir, "quickstart.npz"))
    said = [str(w.message) for w in caught if "rows is not divisible" in str(w.message)]
    check(len(said) == 1 and f"table with {FIT_USERS} rows" in said[0],
          f"the {FIT_USERS}-row user table warns once: {said}")
    W = table_width(FIT_D)
    check((tuple(m._state.item_table.shape), tuple(m._state.user_table.shape))
          == ((FIT_ITEMS // 2, W), (FIT_USERS, W)),
          f"rank {rank} holds {FIT_ITEMS // 2} item rows and the whole user table")
    whole = m._whole_state()  # on the host
    auc, p5 = fit_quality(whole.user_table, whole.item_table, qs)
    check(auc > QS_AUC_FLOOR, f"train AUC {auc:.4f} > {QS_AUC_FLOOR} (p@5 {p5:.4f})")
    out.update(auc=auc, p5=p5, digests=_digests(whole), state_bytes=_state_bytes(m._state))
    return out


def _check_card(torch, mesh, rank: int) -> None:
    """The rank's mesh sits on the rank's own card (``rank_card``; cuda:0
    on a machine with one), which is also its current device."""
    card = torch.device("cuda", rank_card(rank, torch.cuda.device_count()))
    check(mesh.device == card and torch.cuda.current_device() == card.index,
          f"rank {rank} sits on {mesh.device}, its card, bound as the current device")


def _card_mesh(torch, rank: int, n_data: int, n_model: int):
    from lightfm_tpu_torch.parallel import make_mesh

    mesh = make_mesh(n_data=n_data, n_model=n_model)
    _check_card(torch, mesh, rank)
    return mesh


def report_split(ab: list, card: str, backend: str, labels=("a", "b")) -> None:
    """Log and check the records of ``split_rank``'s n ranks: per rank and
    layout the epoch, the collectives (host clock; under NCCL also their
    device time), state and peak bytes, and each serving call; the card
    never held the whole state while placing, each split fit peaks below
    the one-device fit, and the ranks' assembled states are bitwise equal."""
    note = ("gloo moves every collective through the host over loopback" if backend == "gloo"
            else "NCCL, one rank a card")
    for r, rec in enumerate(ab):
        for label, partition in zip(labels, ("rows", "components")):
            x = rec[partition]
            log(f"  ({label}) {partition}, {backend} rank {r} ({card}; {note}): epoch ms (CUDA "
                f"events) {json.dumps(x['epoch_ms'])}; collectives "
                f"{x['collective_ms_per_step']:.3f} ms a step (host clock), "
                f"{x['collective_calls_per_step']:.1f} calls, {x['bytes_per_step'] / 1e6:.3f} MB "
                f"sent a step; state {x['state_bytes'] / 1e6:.3f} MB on the rank of "
                f"{x['whole_bytes'] / 1e6:.3f} MB whole; peak MB above the rank's prior "
                f"allocation: placing {x['peaks']['placed'] / 1e6:.3f}, fitting "
                f"{x['peaks']['fit'] / 1e6:.3f}")
            if backend == "nccl":
                log(f"    the fit's collectives (CUDA events, placement included): "
                    f"{_card_words(x['collectives'])}")
            log(f"    serving, each call from a cold cache ({x['serve_s']:.2f} s of the phase "
                "with the checks): " + "; ".join(
                    f"{name} peak {c['peak'] / 1e6:.3f} MB above the prior allocation, "
                    f"{c['sent'] / 1e6:.3f} MB sent in {c['collectives']} collectives, "
                    f"{c['s'] * 1e3:.1f} ms (host clock), assembled "
                    f"{'/'.join(c['asked']) or 'nothing'}, launches {json.dumps(c['launches'])}"
                    + (f", device {_card_words(c['device'])}" if backend == "nccl" else "")
                    for name, c in x["serve"].items()))
    one_peaks = ab[0]["one_peaks"]
    log(f"  one device, no mesh ({card}): peak MB placing {one_peaks['placed'] / 1e6:.3f}, "
        f"fitting {one_peaks['fit'] / 1e6:.3f}")
    for r, rec in enumerate(ab):
        for partition in ("rows", "components"):
            x = rec[partition]
            check(x["peaks"]["placed"] < x["whole_bytes"],
                  f"{partition}, rank {r}: the card never held the whole state while it was "
                  f"drawn and placed ({x['peaks']['placed'] / 1e6:.3f} < "
                  f"{x['whole_bytes'] / 1e6:.3f} MB)")
            check(x["peaks"]["fit"] < one_peaks["fit"],
                  f"{partition}, rank {r}: the split fit's peak is below the one-device fit's "
                  f"({x['peaks']['fit'] / 1e6:.3f} < {one_peaks['fit'] / 1e6:.3f} MB)")
    for label, partition in zip(labels, ("rows", "components")):
        check(all(rec[partition]["digests"] == ab[0][partition]["digests"] for rec in ab),
              f"({label}) {partition}: the {len(ab)} ranks' assembled states are bitwise equal")


def report_split22(c: list, card: str, backend: str, label: str) -> None:
    """Log and check the records of ``split22_rank``'s four ranks."""
    for r, rec in enumerate(c):
        log(f"  ({label}) {backend} rank {r} ({card}): {FIT_EPOCHS} epochs, median "
            f"{float(np.median(rec['epoch_ms'])):.3f} ms (CUDA events), collectives "
            f"{rec['collective_ms_per_step']:.3f} ms a step (host clock), "
            f"{rec['collective_calls_per_step']:.1f} calls, {rec['bytes_per_step'] / 1e6:.4f} MB "
            f"sent a step; state {rec['state_bytes'] / 1e6:.4f} MB on the rank; AUC "
            f"{rec['auc']:.4f}")
        if backend == "nccl":
            log(f"    the fit's collectives (CUDA events): {_card_words(rec['collectives'])}")
    check(all(rec["digests"] == c[0]["digests"] for rec in c),
          f"({label}) the four ranks' assembled states are bitwise equal")


def checkpoint_one_device(torch, path: str, rec: dict, seed: int, label: str) -> None:
    """``split22_rank``'s last checkpoint loaded into a one-device model on
    this process's card: its state bitwise the ranks' assembled state, and
    its train AUC theirs.  The state arrays go in through
    ``interop.state_from_numpy``: ``load_model``, as the JAX package's,
    refuses a locally shuffled model's file without a mesh."""
    from lightfm_tpu_torch import LightFM
    from lightfm_tpu_torch.interop import state_from_numpy
    from lightfm_tpu_torch.state import ModelState

    with np.load(path) as z:
        arrays = {n: z[f"state_{n}"] for n in ModelState._fields}
    one = LightFM(loss="warp", no_components=FIT_D, random_state=seed)
    one._state = state_from_numpy(arrays, one._device)
    auc, _ = fit_quality(one._state.user_table, one._state.item_table, planted_ml100k(seed))
    check(_digests(one._state) == rec["digests"] and auc == rec["auc"],
          f"({label}) the last checkpoint loads into a one-device model on {one._state.item_table.device} "
          f"bitwise the assembled state (train AUC {auc:.4f})")


def component_adds(torch, seed: int, n: int = 4) -> None:
    """On this card, a step's item touches (TRAIN_BATCH rows over a twentieth
    of TRAIN_ITEMS, so each row has about 26 duplicates) added to the whole
    table and to each of its ``n`` component parts: every part adds bitwise
    as the whole (``ops.updates.accumulate_rows`` pads a part of at most 32
    columns); logs how many entries a plain ``index_put_`` on the parts
    gets otherwise (PyTorch's small-stride kernel sums a row's duplicates
    before it adds them)."""
    from lightfm_tpu_torch.ops.updates import scatter_add
    from lightfm_tpu_torch.state import table_width

    rng = np.random.RandomState(seed)
    R, W, M = TRAIN_ITEMS, table_width(D), TRAIN_BATCH
    dev = torch.device("cuda", torch.cuda.current_device())
    table = torch.from_numpy(rng.randn(R, W).astype(np.float32)).to(dev)
    rows = torch.from_numpy(rng.randint(0, R // 20, M)).to(dev)
    vals = torch.from_numpy(rng.randn(M, W).astype(np.float32)).to(dev)
    whole = table.clone()
    scatter_add(whole, rows, vals)
    k, same, plain = W // n, 0, 0
    for c0 in range(0, W, k):
        c = slice(c0, c0 + k)
        part = table[:, c].contiguous()
        scatter_add(part, rows, vals[:, c].contiguous(), W)
        same += bool(torch.equal(part, whole[:, c]))
        raw = table[:, c].contiguous()
        raw.index_put_((rows,), vals[:, c].contiguous(), accumulate=True)
        plain += int((raw != whole[:, c]).sum())
    log(f"  component parts of {k} of {W} columns: a plain index_put_ on the parts differs from "
        f"the whole table's sums in {plain} of {R * W} entries")
    check(same == n, f"each of the {n} parts of {k} columns adds a step's touches bitwise as "
          f"the whole {W}-column table")


def split_path(torch, seed: int) -> dict:
    """Phase 11: row and component table partitions over ``torch.distributed``,
    in child processes.  Returns each rank's K2 and ``pair_scores`` launch
    counts of its ``predict_rank`` on a split model."""
    import tempfile

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    n_cards = torch.cuda.device_count()
    log(f"phase 11: split tables. (a) rows, (b) components on a (1, 2) mesh of two gloo ranks "
        f"{_where(2, n_cards)}, {TRAIN_USERS} users x {TRAIN_ITEMS} items, D={D}, batch "
        f"{TRAIN_BATCH}, {SPLIT_STEPS} steps; (c) rows on a (2, 2) mesh of four "
        f"{_where(4, n_cards)}, the quickstart size")
    component_adds(torch, seed)
    card = nvidia_smi("name,power.limit")
    with tempfile.TemporaryDirectory() as tmp:
        for sub in ("ab", "c"):
            os.makedirs(os.path.join(tmp, sub))
        t0 = time.perf_counter()
        ab = run_ranks(torch, "gloo", 2, seed, os.path.join(tmp, "ab"), part="split")
        secs_ab = time.perf_counter() - t0
        t0 = time.perf_counter()
        c = run_ranks(torch, "gloo", 4, seed, os.path.join(tmp, "c"), part="split22")
        secs_c = time.perf_counter() - t0
        checkpoint_one_device(torch, os.path.join(tmp, "c", "quickstart.npz"), c[0], seed, "c")
    report_split(ab, card, "gloo")
    report_split22(c, card, "gloo", "c")
    secs = time.perf_counter() - t_phase
    log(f"  phase 11: {secs:.1f} s ((a, b) {secs_ab:.1f}, (c) {secs_c:.1f}, child start-up "
        "included)")
    return {f"split gloo rank {r} {partition} predict_rank": rec[partition]["predict_rank_launches"]
            for r, rec in enumerate(ab) for partition in ("rows", "components")}


# Phase 12: NCCL across cards, one rank a card, in child processes as phases
# 10 and 11; it runs where the machine has two cards or more (cards_plan).
# (a) data-parallel on (n, 1): the 5M fast fit through K1 under NCCL, then
# the same fit under gloo on the same cards, bitwise; (b) rows and (c)
# components on (1, n): split_rank under NCCL; (d) at n = 4, split22_rank
# under NCCL.  Its own timeouts, so that an NCCL hang fails fast.
CARDS_EPOCHS = 2
CARDS_CHILD_TIMEOUT_S = 180
CARDS_PG_TIMEOUT_S = 90


def cards_plan(n_cards: int) -> dict:
    """Phase 12's ranks and parts on a machine with ``n_cards`` cards: one
    rank a card on the largest power of two up to min(4, n_cards) (the row
    splits of 100,000 items and 200,000 users need n to divide both, which
    3 does not), with (d), a (2, 2) mesh, at four; none below two cards."""
    ranks = 4 if n_cards >= 4 else 2 if n_cards >= 2 else 0
    return {"ranks": ranks, "parts": ("a", "b", "c", "d")[:{0: 0, 2: 3, 4: 4}[ranks]]}


def cards_with_context() -> list:
    """The cards (ordinals) on which this process holds an active primary
    CUDA context, from libcuda (``cuDevicePrimaryCtxGetState``)."""
    cu = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_int()
    if cu.cuDeviceGetCount(ctypes.byref(n)):
        raise RuntimeError("cuDeviceGetCount failed")
    out = []
    for i in range(n.value):
        dev, flags, active = ctypes.c_int(), ctypes.c_uint(), ctypes.c_int()
        if cu.cuDeviceGet(ctypes.byref(dev), i) or cu.cuDevicePrimaryCtxGetState(
                dev, ctypes.byref(flags), ctypes.byref(active)):
            raise RuntimeError(f"libcuda refused to report card {i}'s context")
        if active.value:
            out.append(i)
    return out


def compute_apps(n_cards: int) -> dict:
    """``nvidia-smi``'s compute processes: its lines as printed, and their
    count on each card by index."""
    def query(what):
        return subprocess.run(["nvidia-smi", what, "--format=csv,noheader"], check=True,
                              capture_output=True, text=True, timeout=60).stdout.strip().splitlines()

    index = {}
    for line in query("--query-gpu=index,uuid"):
        i, uuid = (x.strip() for x in line.split(","))
        index[uuid] = int(i)
    lines = query("--query-compute-apps=pid,gpu_uuid,used_memory")
    per_card = [0] * n_cards
    for line in lines:
        fields = [x.strip() for x in line.split(",")]
        if len(fields) == 3 and fields[1] in index:
            per_card[index[fields[1]]] += 1
    return {"lines": lines, "per_card": per_card}


def topology() -> list:
    """What ``nvidia-smi`` says of the links between the cards: ``topo -m``
    and card 0's NVLink status, line by line, or a query's exit code and
    first line where the machine refuses it (a container may)."""
    out = []
    for args in (["topo", "-m"], ["nvlink", "--status", "-i", "0"]):
        r = subprocess.run(["nvidia-smi", *args], capture_output=True, text=True, timeout=60)
        lines = (r.stdout + r.stderr).strip().splitlines() or [""]
        name = "nvidia-smi " + " ".join(args)
        out += ([f"{name}: {line}" for line in lines] if r.returncode == 0
                else [f"{name}: exit {r.returncode}: {lines[0]}"])
    return out


def cards_rank(torch, seed: int, rank: int, out_dir: str) -> dict:
    """(a) ``make_mesh(n_data=n)``, one rank a card, under NCCL or gloo: the
    ``synth-5m-warp-d64`` fit of CARDS_EPOCHS epochs on the data-parallel
    fast path, K1 at 2 launches a step; the state's digests (the parent
    holds them across ranks and backends); ``recommend`` through
    ``top_k_sharded`` against ``top_k`` on the same state without a mesh;
    epoch and collective times, peaks while placing, fitting and serving;
    the cards on which this process holds a context once its mesh is made
    and at the end (under NCCL its own card alone), and under NCCL rank
    0's compute-apps listing taken while every rank holds its group."""
    import pickle

    import torch.distributed as dist

    from lightfm_tpu_torch import LightFM
    from lightfm_tpu_torch.parallel.mesh import barrier

    n = dist.get_world_size()
    mesh = _card_mesh(torch, rank, n_data=n, n_model=1)
    at_mesh = cards_with_context()
    coo = clustered_interactions(TRAIN_USERS, TRAIN_ITEMS, TRAIN_NNZ, seed)
    m = LightFM(loss="warp", no_components=D, batch_size=TRAIN_BATCH, random_state=seed,
                mesh=mesh)
    out, peaks = _fit_peaks(torch, _mesh_fit, torch, m, mesh, coo, CARDS_EPOCHS)
    check(m._staged_fast == "einsum", "the mesh fit took the data-parallel fast path")
    k1 = out["launches"]["sorted_adagrad_update"]
    check(k1 == 2 * out["steps"], f"K1 launched 2 x {out['steps']} steps = {k1} times on rank {rank}")
    out["digests"] = _digests(m._state)

    users = np.arange(0, TRAIN_USERS, TRAIN_USERS // MESH_REC_USERS)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s_mesh, i_mesh = m.recommend(users, k=10)
    torch.cuda.synchronize()
    out["serve_s"] = time.perf_counter() - t0
    peaks["serve"] = torch.cuda.max_memory_allocated() - held
    out.update(peaks=peaks, serve_collectives=_collectives())
    one = pickle.loads(pickle.dumps(m))  # the same state, no mesh
    s_one, i_one = one.recommend(users, k=10)
    check(np.array_equal(i_mesh, i_one), "recommend through top_k_sharded returns top_k's ids")
    err = float(np.abs(s_mesh - s_one).max())
    check(err <= 1e-6, f"and its scores (max |d| {err:.3g}, bitwise {np.array_equal(s_mesh, s_one)})")
    out["rec_max_abs_err"] = err

    out["contexts"] = {"mesh": at_mesh, "end": cards_with_context()}
    if dist.get_backend() != "nccl":  # gloo binds no card: logged, not held
        return out
    check(out["contexts"]["end"] == [mesh.device.index],
          f"rank {rank} holds a CUDA context on its own card alone ({out['contexts']['end']})")
    barrier(mesh)  # every rank holds its group and its context
    if rank == 0:
        out["apps"] = compute_apps(torch.cuda.device_count())
    barrier(mesh)
    return out


def cards_path(torch, seed: int) -> dict:
    """Phase 12: NCCL across cards, one rank a card, in child processes.
    On a machine with one card it logs that it needs two and returns
    nothing.  Returns each rank's launch counts of its data-parallel fit
    and of its split ``predict_rank``."""
    import tempfile

    from lightfm_tpu_torch.ops import _build

    n_cards = torch.cuda.device_count()
    plan = cards_plan(n_cards)
    if not plan["ranks"]:
        log(f"phase 12: NCCL across cards needs two cards; this machine has {n_cards}")
        return {}
    n = plan["ranks"]
    t_phase = time.perf_counter()
    _build.build_all()  # built by phase 1; the children only load the libraries
    torch.cuda.empty_cache()
    log(f"phase 12: NCCL across cards, one rank a card on {n} of {n_cards}: (a) data-parallel "
        f"on ({n}, 1), {CARDS_EPOCHS} epochs of {TRAIN_USERS} users x {TRAIN_ITEMS} items, "
        f"D={D}, batch {TRAIN_BATCH}, under NCCL, then gloo on the same cards; (b) rows, "
        f"(c) components on (1, {n}), {SPLIT_STEPS} steps"
        + ("; (d) rows on (2, 2), the quickstart size" if "d" in plan["parts"] else ""))
    card = nvidia_smi("name,power.limit")
    cards = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit",
                            "--format=csv,noheader"], check=True, capture_output=True, text=True,
                           timeout=60).stdout.strip().splitlines()
    log("  cards: " + " | ".join(cards))
    for line in topology():
        log(f"  {line}")
    secs, launches = {}, {}
    kw = dict(timeout_s=CARDS_CHILD_TIMEOUT_S, pg_timeout_s=CARDS_PG_TIMEOUT_S)
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for name, backend, world, part in (
                ("a nccl", "nccl", n, "cards"), ("a gloo", "gloo", n, "cards"),
                ("b, c", "nccl", n, "split"), ("d", "nccl", 4, "split22")):
            if name == "d" and "d" not in plan["parts"]:
                continue
            os.makedirs(os.path.join(tmp, name))
            t0 = time.perf_counter()
            runs[name] = run_ranks(torch, backend, world, seed, os.path.join(tmp, name), part=part,
                                   **kw)
            secs[name] = time.perf_counter() - t0
        if "d" in runs:
            checkpoint_one_device(torch, os.path.join(tmp, "d", "quickstart.npz"), runs["d"][0],
                                  seed, "d")

    for backend in ("nccl", "gloo"):
        for r, rec in enumerate(runs[f"a {backend}"]):
            p = rec["peaks"]
            log(f"  (a) {backend} rank {r} ({card}): epoch ms (CUDA events) "
                f"{json.dumps(rec['epoch_ms'])}; collectives {rec['collective_ms_per_step']:.3f} "
                f"ms a step (host clock), {rec['collective_calls_per_step']:.1f} calls, "
                f"{rec['bytes_per_step'] / 1e6:.3f} MB sent a step; K1 "
                f"{rec['launches']['sorted_adagrad_update']} launches; peak MB above the rank's "
                f"prior allocation: placing {p['placed'] / 1e6:.3f}, fitting "
                f"{p['fit'] / 1e6:.3f}, recommend {p['serve'] / 1e6:.3f} "
                f"({rec['serve_s'] * 1e3:.1f} ms, host clock)")
            log(f"    the fit's collectives (CUDA events, placement included): "
                f"{_card_words(rec['collectives'])}; recommend's: "
                f"{_card_words(rec['serve_collectives'])}; CUDA contexts on cards "
                f"{rec['contexts']['mesh']} once the mesh was made, {rec['contexts']['end']} "
                "at the end")
    nccl, gloo = runs["a nccl"], runs["a gloo"]
    for backend, recs in (("nccl", nccl), ("gloo", gloo)):
        check(all(rec["digests"] == recs[0]["digests"] for rec in recs),
              f"(a) {backend}: the {n} replicas are bitwise equal")
    check(nccl[0]["digests"] == gloo[0]["digests"],
          "(a) the NCCL state is bitwise the gloo state on the same mesh and cards")
    apps = nccl[0]["apps"]
    for line in apps["lines"]:
        log(f"  compute apps (pid, card, memory) while the NCCL ranks held their groups: {line}")
    if apps["lines"]:
        mine = cards_with_context()  # this process's own contexts (cuda:0 after phases 1-11)
        want = [(1 if i < n else 0) + (i in mine) for i in range(n_cards)]
        check(apps["per_card"] == want, f"(a) nvidia-smi lists one rank's process on each of the "
              f"{n} cards, and this process on {mine} ({apps['per_card']})")
    else:
        log("  nvidia-smi lists no compute process here; the ranks' own context checks stand")
    report_split(runs["b, c"], card, "nccl", labels=("b", "c"))
    if "d" in runs:
        report_split22(runs["d"], card, "nccl", "d")
    for backend in ("nccl", "gloo"):
        for r, rec in enumerate(runs[f"a {backend}"]):
            launches[f"cards {backend} rank {r} data-parallel fit"] = rec["launches"]
    for r, rec in enumerate(runs["b, c"]):
        for partition in ("rows", "components"):
            launches[f"cards nccl rank {r} {partition} predict_rank"] = (
                rec[partition]["predict_rank_launches"])
    total = time.perf_counter() - t_phase
    log(f"  phase 12: {total:.1f} s ({', '.join(f'({k}) {v:.1f}' for k, v in secs.items())}, "
        "child start-up included)")
    return launches


def touch_record(touch: dict) -> dict:
    """Phase 4c's kernel record: the item shape's times, both shapes'."""
    items = touch["cases"]["item"]
    return {
        "name": "touch_adagrad_update", "route": "cuda",
        "source": "lightfm_tpu_torch/csrc/adagrad_update.cu",
        "replaces": "lightfm_tpu/ops/updates.py:43 (XLA scatter-adds; no pallas_call)",
        "launches": touch["cases"]["fit"]["launches"], "max_abs_err": touch["worst"],
        "ms": items["ms"], "plain_ms": items["plain_ms"], "bound_ms": items["bound_ms"],
        "bound_by": "bytes", "library_ms": items["library_ms"],
        "device_ms": items["device_ms"], "sort_ms": items["sort_ms"],
        "user": {k: touch["cases"]["user"][k] for k in
                 ("ms", "device_ms", "sort_ms", "plain_ms", "library_ms", "bound_ms")},
    }


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    # A child of phases 10-12 (run_ranks): its backend, rank and rendezvous.
    p.add_argument("--mesh-rank", choices=("nccl", "gloo"), help=argparse.SUPPRESS)
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, help=argparse.SUPPRESS)
    p.add_argument("--out", help=argparse.SUPPRESS)
    p.add_argument("--part", default="mesh", choices=("mesh", "split", "split22", "cards"),
                   help=argparse.SUPPRESS)
    p.add_argument("--pg-timeout", type=float, default=MESH_PG_TIMEOUT_S, help=argparse.SUPPRESS)
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if args.mesh_rank:
        return mesh_rank_main(torch, args)
    from lightfm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    log(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s")
    for name in ("rank_counts", "warp_fit"):  # adagrad_update's: phase 4, grad_sums': 4b
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}:", line.strip())
    spills = [ln for ln in _build.build_log("rank_counts").splitlines() if "spill" in ln]
    check(all(" 0 bytes spill stores, 0 bytes spill loads" in ln for ln in spills),
          f"ptxas: no rank_counts template spills ({len(spills)} functions reported)")
    card = nvidia_smi("name,power.limit")

    i_pad = -(-(N_ITEMS + 1) // 2048) * 2048  # the ranking path's padded catalog
    kernels = kernel_checks(torch, args.seed, i_pad)
    launches = serving_path(torch, args.seed)
    for rec in kernels:
        rec["launches"] = launches[rec["name"]]
        check(rec["launches"] > 0, f"{rec['name']} launched on the serving path")

    k1_cases = update_kernel_checks(torch, args.seed)
    k3_cases = grad_sums_checks(torch, args.seed)
    touch = touch_update_checks(torch, args.seed)
    trained = training_path(torch, args.seed)
    hybrid = hybrid_path(torch, args.seed)
    k5 = warp_fit_path(torch, args.seed)
    generic_path(torch, args.seed, trained)
    data_path(torch, args.seed)
    mesh_launches = mesh_path(torch, args.seed)
    log("  kernel launches by path, phase 10 (each counted from 0 in its rank): "
        + json.dumps(mesh_launches))
    split_launches = split_path(torch, args.seed)
    log("  kernel launches by path, phase 11 (each counted from 0 in its rank): "
        + json.dumps(split_launches))
    for rec in kernels:
        rec["launches_split"] = {k: v[rec["name"]] for k, v in split_launches.items()}
        check(all(v > 0 for v in rec["launches_split"].values()),
              f"{rec['name']} launched on every rank's split predict_rank")
    check(all(v["sorted_adagrad_update"] > 0 for k, v in mesh_launches.items() if "fit warp" in k),
          "sorted_adagrad_update launched on every rank's mesh fit")
    cards_launches = cards_path(torch, args.seed)
    if cards_launches:
        log("  kernel launches by path, phase 12 (each counted from 0 in its rank): "
            + json.dumps(cards_launches))
        check(all(v["sorted_adagrad_update"] > 0 for k, v in cards_launches.items()
                  if k.endswith("fit")), "sorted_adagrad_update launched on every rank's "
              "data-parallel fit across cards")
        check(all(v["rank_counts"] > 0 and v["pair_scores"] > 0 for k, v in cards_launches.items()
                  if k.endswith("predict_rank")), "rank_counts and pair_scores launched on every "
              "rank's split predict_rank across cards")
    items, k4 = trained["rows"]["items"], trained["rows"]["k4"]
    k1_launches = trained["launches"]["sorted_adagrad_update"]
    check(k1_launches > 0, "sorted_adagrad_update launched on the training path")
    kernels += [
        {
            "name": "sorted_adagrad_update", "route": "cuda",
            "source": "lightfm_tpu_torch/csrc/adagrad_update.cu",
            "replaces": "lightfm_tpu/ops/pallas_update.py:234",
            "launches": k1_launches,
            "launches_mesh": mesh_launches["mesh nccl x1 rank fit warp"]["sorted_adagrad_update"],
            "max_abs_err": max(k1_cases["worst"], items["max_abs_err"],
                               trained["rows"]["users"]["max_abs_err"]),
            "ms": items["ms"], "plain_ms": items["plain_ms"], "bound_ms": items["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "device_ms": items["device_ms"], "distinct": items["distinct"],
            "hottest": items["hottest"], "ms_zipf": k1_cases["cases"]["Zipf items"]["ms"],
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
    kernels.append(touch_record(touch))
    k3 = hybrid["row"]
    check(hybrid["launches"]["sorted_grad_sums"] > 0, "sorted_grad_sums launched on the hybrid path")
    check(k5["launches"] > 0, "warp_fit_fused launched on the whole-fit path")
    kernels += [
        {
            "name": "sorted_grad_sums", "route": "cuda",
            "source": "lightfm_tpu_torch/csrc/grad_sums.cu",
            "replaces": "lightfm_tpu/ops/pallas_update.py:365",
            "launches": hybrid["launches"]["sorted_grad_sums"],
            "max_abs_err": max(k3_cases["worst"], k3["max_abs_err"]),
            "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
            "bound_by": "bytes", "library_ms": k3["library_ms"],
            "device_ms": k3["device_ms"], "distinct": k3["distinct"],
            "hottest": k3["hottest"], "ms_zipf": k3_cases["cases"]["Zipf items"]["ms"],
            "hot_row_sweep": {k.split("=")[1]: {"ms": v["ms"], "device_ms": v["device_ms"]}
                              for k, v in k3_cases["cases"].items() if k.startswith("hot row")},
        },
        {
            "name": "warp_fit_fused", "route": "cuda",
            "source": "lightfm_tpu_torch/csrc/warp_fit.cu",
            "replaces": "lightfm_tpu/ops/pallas_train.py:174",
            "launches": k5["launches"], "max_abs_err": k5["max_abs_err"],
            "ms": k5["ms"], "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
            "bound_by": k5["bound_by"], "library_ms": None,
            **{k: k5[k] for k in ("steps", "ms_per_step", "chain_floor_ms", "bound_with_chain_ms",
                                  "grid_blocks", "barrier_us", "l2_trip_ns")},
        },
    ]

    for rec in kernels:  # phase 12's counts where a kernel ran there ({} on one card)
        rec["launches_cards"] = {k: v[rec["name"]] for k, v in cards_launches.items()
                                 if v.get(rec["name"])}
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
