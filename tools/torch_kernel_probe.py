"""Probe the port's small kernels on one NVIDIA GPU, for before/after notes.

    python3 tools/torch_kernel_probe.py [--tree DIR] [--pair] [--gather]
                                        [--barrier] [--k5-phases SOURCE]
                                        [--out FILE]

``--pair``: ``pair_scores`` at the shapes of its four launches in a
``predict_rank`` at the serving size (Wa = 73, a catalog of 100,352 rows),
the serving shape against a catalog of 20,000 rows (5.8 MB, which the L2
holds), and phase 3's D = 712 call (Wa = 721, 1,024 users): device time by ``torch.profiler``, CUDA events over 50 calls,
the wrapper's host enqueue, and the two-call yardstick ``(u[:, None] *
items[idx]).sum(-1)``, with each shape's bytes bound.

``--gather``: the L2's rate for ``pair_scores``' gather at the serving
shape: a kernel with a warp per gathered row, 8 rows a warp in flight and
the card's every SM full, that only sums each row, on random rows of the
100,352- and 20,000-row catalogs and on rows in order, beside
``pair_scores``' device time on the same rows.

``--gather``'s kernel is built from a source written into a temporary
directory.

``--barrier``: the cost of one ``grid.sync()`` on an empty cooperative
grid (1 to 264 blocks of the fit's 512 threads) and one thread's L2 and
device-memory latency (a pointer chase over rings of 4 MB and 256 MB),
by the probes of ``csrc/warp_fit.cu`` that ``chip_smoke.py`` times the
chain floor with (so not with a ``--tree`` whose K5 has none).

``--k5-phases SOURCE``: the one-block whole-fit kernel (a
``csrc/warp_fit.cu`` whose steps are a forward, a bitonic sort and a
segmented apply, each closed by ``__syncthreads()``, as in the git
history before the cooperative grid) copied into a temporary directory
with ``clock64()`` stamps at those three barriers, built, run on
``chip_smoke.py``'s phase-7 inputs, and its time split by phase.  The
copy's final state is checked bitwise against the unstamped kernel of
the same source.

``--tree DIR`` imports ``lightfm_tpu_torch`` from another checkout (the
parent unpacked with ``git archive``, say); ``chip_smoke`` always comes
from this one.  Results print as JSON lines and, with ``--out``, into FILE.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The L2's rate for pair_scores' gather: a warp per row, 8 rows' loads a
# warp in flight, every block of the card full; each row is summed (not
# row_dot's chain, a time only) and one float a row written.
GATHER = r"""
#include <cuda_runtime.h>
constexpr int kRows = 8;
__global__ void __launch_bounds__(256) gather_roof_kernel(
    const float* __restrict__ rows, const int* __restrict__ idx,
    float* __restrict__ out, long long n, int Wa) {
  const int lane = threadIdx.x & 31;
  const long long nw = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long p0 = (((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * kRows;
       p0 < n; p0 += nw * kRows) {
    const int my = p0 + lane < n && lane < kRows ? idx[p0 + lane] : 0;
    float v[kRows][3];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const float* r = rows + (size_t)__shfl_sync(~0u, my, j) * Wa;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const int c = lane + 32 * q;
        v[j][q] = p0 + j < n && c < Wa ? __ldg(r + c) : 0.0f;
      }
    }
    float mine = 0.0f;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      float s = v[j][0] + v[j][1] + v[j][2];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(~0u, s, o);
      if (lane == j) mine = s;
    }
    if (lane < kRows && p0 + lane < n) out[p0 + lane] = mine;
  }
}
extern "C" int gather_roof_launch(const float* rows, const int* idx, float* out,
                                  long long n, int Wa, int blocks, void* stream) {
  if (Wa > 96) return (int)cudaErrorInvalidValue;
  gather_roof_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(rows, idx, out, n, Wa);
  return (int)cudaGetLastError();
}
"""

# Where the one-block kernel's three phases end (after the text before the
# "|"), each to be followed by a stamp of its phase.
STAMPS = (
    "    for (int i = 3 * B + tid; i < N; i += kThreads) keys[i] = kEmpty;\n"
    "    __syncthreads();\n|",
    "        __syncthreads();\n      }\n    }\n|",
    "    __syncthreads();\n|  }\n}\n",
)


def _build(nvcc_flags, nvcc, src: str, name: str, tmp: str) -> ctypes.CDLL:
    path = os.path.join(tmp, name + ".cu")
    with open(path, "w") as fh:
        fh.write(src)
    so = os.path.join(tmp, name + ".so")
    r = subprocess.run([nvcc, *nvcc_flags, "-o", so, path], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(so)


def stamped_source(src: str) -> str:
    """The one-block kernel with clock64() stamps after its three barriers."""
    for phase, mark in enumerate(STAMPS):
        before, after = mark.split("|")
        if src.count(before + after) != 1:
            raise ValueError(f"--k5-phases: barrier {phase} not found once in the source")
        stamp = ("    if (tid == 0) { long long t = clock64(); "
                 f"stamps[{phase}] += t - t_prev; t_prev = t; }}\n")
        src = src.replace(before + after, before + stamp + after)
    head = "float* gu, unsigned long long* gkeys, int N, int keys_in_smem) {"
    launch = "unsigned long long* keys, int N, void* stream) {"
    call = "(float)(n_items - 1), lr, max_loss, lu, gu, keys, N, in_smem);"
    for text in (head, launch, call):
        if src.count(text) != 1:
            raise ValueError("--k5-phases: the source is not the one-block kernel")
    src = src.replace(head, head[:-3] + ", long long* stamps) {\n  long long t_prev = clock64();")
    src = src.replace(launch, launch[:-3] + ", long long* stamps) {")
    return src.replace(call, call[:-2] + ", stamps);")


def pair_probe(torch, cs, rc) -> dict:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, U, C, I, Wa in (("serving C=10", 50_000, 10, 100_352, 73),
                              ("light exclusion C=32", 49_920, 32, 100_352, 73),
                              ("heavy exclusion C=416", 256, 416, 100_352, 73),
                              ("heavy C=10", 256, 10, 100_352, 73),
                              ("serving C=10, catalog of 20,000", 50_000, 10, 20_000, 73),
                              ("D=712 (Wa=721) U=1,024 C=20", 1_024, 20, 100_352, 721)):
        items = torch.randn((I, Wa), generator=g, device=dev)
        u = torch.randn((U, Wa), generator=g, device=dev)
        idx = torch.randint(0, I, (U, C), generator=g, device=dev).int()

        def run(u=u, items=items, idx=idx):
            return rc.pair_scores(u, items, idx)

        def two_calls(u=u, items=items, idx=idx):
            return (u[:, None, :] * items[idx.long()]).sum(-1)

        rows = int(torch.unique(idx).numel())
        out[name] = {
            "device_ms": sum(cs.device_ms(torch, run, reps=20).values()),
            "events_ms": cs.time_ms(torch, run, reps=50),
            "host_enqueue_ms": cs.host_ms(torch, run, reps=50),
            "yardstick_ms": cs.time_ms(torch, two_calls, reps=10),
            "bound_ms": 4 * (U * Wa + rows * Wa + 2 * U * C) / cs.HBM_BYTES_PER_S * 1e3,
        }
        print(json.dumps({"pair_scores": name, **out[name]}), flush=True)
    return out


def gather_probe(torch, cs, lib) -> dict:
    """The L2's gather rate at pair_scores' serving shape (500,000 rows of
    Wa = 73 from a catalog of 100,352 or 20,000 rows, random, as the
    serving path draws them, or in order), beside pair_scores itself."""
    from lightfm_tpu_torch.ops import rank_counts as rc

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    lib.gather_roof_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                                                ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    U, C, Wa = 50_000, 10, 73
    u = torch.randn((U, Wa), generator=g, device=dev)
    res = {}
    for name, I, order in (("random, catalog of 100,352", 100_352, "random"),
                           ("random, catalog of 20,000", 20_000, "random"),
                           ("in order, catalog of 100,352", 100_352, "order")):
        items = torch.randn((I, Wa), generator=g, device=dev)
        idx = (torch.randint(0, I, (U, C), generator=g, device=dev).int() if order == "random"
               else (torch.arange(U * C, device=dev) % I).int().view(U, C))
        out = torch.empty(U * C, device=dev)

        def roof(items=items, idx=idx, out=out):
            code = lib.gather_roof_launch(items.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                          U * C, Wa, sms * 8, stream)
            if code:
                raise RuntimeError(f"gather_roof launch failed ({code})")

        def pairs(items=items, idx=idx):
            return rc.pair_scores(u, items, idx)

        gathered = U * C * 4 * Wa
        ms = sum(cs.device_ms(torch, roof, reps=20).values())
        res[name] = {"roof_device_ms": ms, "roof_TB_s": gathered / ms / 1e9,
                     "pair_scores_device_ms": sum(cs.device_ms(torch, pairs, reps=20).values()),
                     "gathered_MB": gathered / 1e6}
        print(json.dumps({"gather": name, **res[name]}), flush=True)
    return res


def barrier_probe(torch, cs, wf) -> dict:
    """K5's probes (``chip_smoke.k5_probes``): one ``grid.sync()`` of an
    empty cooperative grid of 1 to 264 blocks of the fit's 512 threads,
    and one thread's L2 and device-memory latency."""
    barrier, trip = cs.k5_probes(torch, wf)
    res = {"grid_sync": {f"{n}x512": {"us_per_sync": barrier(n) * 1e3} for n in (1, 66, 132, 264)},
           "latency": {f"{n_el * 4 >> 20} MB": {"ns_per_hop": trip(n_el) * 1e6}
                       for n_el in (1 << 20, 1 << 26)}}
    print(json.dumps(res), flush=True)
    return res


def k5_phase_probe(torch, cs, wf, build, source: str, tmp: str) -> dict:
    with open(source) as fh:
        lib = _build(build.NVCC_FLAGS, build._nvcc(), stamped_source(fh.read()), "k5_stamped", tmp)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.warp_fit_launch.argtypes = [p] * 7 + [i] * 6 + [f, f, p, p, p, i, p, p]
    inp = cs.fit_inputs(torch, 0)
    tables, bt, ng, pos, kw = (inp[k] for k in ("tables", "batches_t", "negs_t", "positives", "kw"))
    dev = torch.device("cuda")
    S, B, W = bt.shape[0], bt.shape[2], tables[0].shape[1]
    N = 1 << (3 * B - 1).bit_length()
    stamps = torch.zeros(3, dtype=torch.int64, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def stamped():
        out = [x.clone() for x in tables]
        lu = torch.empty((B, W), device=dev)
        gu = torch.empty((B, W), device=dev)
        keys = torch.empty((N,), dtype=torch.int64, device=dev)
        code = lib.warp_fit_launch(*(x.data_ptr() for x in out), bt.data_ptr(), ng.data_ptr(),
                                   pos.data_ptr(), S, B, kw["max_sampled"], W, pos.shape[1],
                                   kw["n_items"], kw["learning_rate"], 10.0, lu.data_ptr(),
                                   gu.data_ptr(), keys.data_ptr(), N, stream, stamps.data_ptr())
        if code:
            raise RuntimeError(f"stamped K5 launch failed ({code})")
        return out

    same = all(torch.equal(a, b) for a, b in zip(stamped(), wf.warp_fit_fused(*tables, bt, ng, pos, **kw)))
    torch.cuda.synchronize()
    stamps.zero_()
    ms = cs.time_ms(torch, stamped, reps=3)  # a warm-up call and 3 timed ones add stamps
    cyc = stamps.cpu().numpy().astype(np.float64) / 4
    share = cyc / cyc.sum()
    res = {"steps": S, "B": B, "W": W, "ms": ms, "bitwise_as_unstamped": same,
           "phases": dict(zip(("forward", "sort", "apply"), share.tolist())),
           "us_per_step": dict(zip(("forward", "sort", "apply"), (share * ms / S * 1e3).tolist()))}
    print(json.dumps({"k5_phases": res}), flush=True)
    return res


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", default=None)
    p.add_argument("--pair", action="store_true")
    p.add_argument("--gather", action="store_true")
    p.add_argument("--barrier", action="store_true")
    p.add_argument("--k5-phases", default=None, metavar="SOURCE")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_probe: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from lightfm_tpu_torch.ops import _build as build
    from lightfm_tpu_torch.ops import rank_counts as rc
    from lightfm_tpu_torch.ops import warp_fit as wf

    build.build_all()
    result = {"card": cs.nvidia_smi("name,power.limit"), "package": os.path.dirname(rc.__file__)}
    print(json.dumps(result), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        if args.pair:
            result["pair_scores"] = pair_probe(torch, cs, rc)
        if args.gather:
            lib = _build(build.NVCC_FLAGS, build._nvcc(), GATHER, "gather", tmp)
            result["gather"] = gather_probe(torch, cs, lib)
        if args.barrier:
            result.update(barrier_probe(torch, cs, wf))
        if args.k5_phases:
            result["k5_phases"] = k5_phase_probe(torch, cs, wf, build, args.k5_phases, tmp)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
