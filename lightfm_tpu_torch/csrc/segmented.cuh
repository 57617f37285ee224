// The segmented reduction over sorted touches that the adagrad update (K1,
// csrc/adagrad_update.cu) and the gradient sums (K3, csrc/grad_sums.cu)
// share.  The two kernels differ only in what a finished run does: K1 applies
// the adagrad step to its table row, K3 stores the run's sums.  Each passes
// that as a `Finish` object:
//     finish(rows, c0, cw, lane, s, s2)
// takes NR rows (a row < 0 is skipped) with their sums at columns
// [c0, c0 + cw) of (sum wg | sum wg^2), this lane's columns c0 + lane + 32 * q.
//
// Design: two launches, no atomics.
// - Pass A.  The M positions are cut into segments of kSeg.  One block takes
//   one segment: it starts 16-byte cp.async copies of the segment's [kSeg, W]
//   gradient slab into shared memory (in column chunks of 32 * CPL, so any W
//   that is a multiple of 4 fits), finds the run starts of the segment's ids
//   with one ballot per 32 positions while the copies fly, then gives the
//   runs to the warps, kInFlight at a time, which sum them from shared memory
//   in fp32, in touch order.  A run that begins and ends inside the segment
//   has this block as its only writer: the warp finishes it at once, kInFlight
//   runs together.  The run that enters from the segment before, or the one
//   that starts here and leaves into the next, is written instead as a
//   partial (sum wg | sum wg^2) row to the scratch `part` [segments, 2, 2W]:
//   slot 0 for the entering run, slot 1 for the leaving one.
// - Pass B.  One warp for each segment but the last.  It returns unless a
//   run starts in its segment and leaves it.  Then it votes on the first ids
//   of the next 32 segments: a run of at most 32 partials is added by the
//   warp, in segment order, and finished.  A longer run goes to the whole
//   block, which counts its segments with block-wide votes and adds its
//   partials in a fixed tree: warp w takes partials w, w + 8, ... in order,
//   and the eight warp sums are added in warp order.  A run of n touches
//   costs about n / kSeg partial reads spread over a block instead of n
//   serial trips.
// Every sum's order depends only on the positions, so two launches are
// bitwise equal.  Rows outside [0, R) are skipped in both passes.  At bf16
// precision every wg and wg*wg (computed in fp32) is rounded to bf16, nearest
// even, before the fp32 sum: the TPU's DEFAULT-precision one-hot matmul.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace segmented {

constexpr int kSeg = 64;        // touch positions of one pass-A segment
constexpr int kThreads = 256;   // both passes: 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 4;     // columns a lane holds per chunk (128 a chunk)
constexpr int kInFlight = 2;    // pass-A runs a warp finishes at once
static_assert(kSeg % 32 == 0 && kThreads >= kSeg + 2, "segment layout");

template <bool kBf16>
__device__ __forceinline__ float rounded(float x) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage columns [c0, c0 + cw) of the segment's n gradient rows into `slab`
// (rows of 32 * CPL floats) with 16-byte copies: the launcher takes only a
// 16-byte-aligned swg and W % 4 == 0, so every row start and cw are
// multiples of 4 floats.
template <int CPL>
__device__ __forceinline__ void load_chunk(float* slab, const float* swg,
                                           long long j0, int n, int W, int c0,
                                           int cw) {
  constexpr int CW = 32 * CPL;
  const float* base = swg + j0 * W + c0;
  const int per_row = cw >> 2;
  for (int v = threadIdx.x; v < n * per_row; v += kThreads) {
    const int p = v / per_row, q = (v - p * per_row) << 2;
    cp_async16(slab + p * CW + q, base + (long long)p * W + q);
  }
}

// Run starts of the segment's n ids: one ballot per 32 positions, ranked by
// a prefix count.  Writes the starts in order to starts[0, n_runs) and n to
// starts[n_runs]; returns n_runs.  Every thread of the block calls it.
__device__ __forceinline__ int run_starts(const int* ids, int n, int* starts,
                                          int* warp_runs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = warp * 32 + lane;
  bool start = false;
  unsigned mask = 0;
  if (warp < kSeg / 32) {
    start = i < n && (i == 0 || ids[i] != ids[i - 1]);
    mask = __ballot_sync(0xffffffffu, start);
    if (lane == 0) warp_runs[warp] = __popc(mask);
  }
  __syncthreads();
  int n_runs = 0, before = 0;
#pragma unroll
  for (int w = 0; w < kSeg / 32; ++w) {
    before += w < warp ? warp_runs[w] : 0;
    n_runs += warp_runs[w];
  }
  if (start) starts[before + __popc(mask & ((1u << lane) - 1u))] = i;
  if (threadIdx.x == 0) starts[n_runs] = n;
  return n_runs;
}

// Pass A for segment blockIdx.x.
template <int CPL, bool kBf16, typename Finish>
__device__ __forceinline__ void segment_pass(const Finish& finish,
                                             const int* __restrict__ sidx,
                                             const float* __restrict__ swg,
                                             float* __restrict__ part,
                                             long long M, int R, int W) {
  constexpr int CW = 32 * CPL;
  __shared__ __align__(16) float slab[kSeg * CW];
  __shared__ int ids[kSeg];
  __shared__ int starts[kSeg + 1];
  __shared__ int warp_runs[kSeg / 32];
  __shared__ int edge[2];  // the ids just before and just after the segment

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long seg = blockIdx.x;
  const long long j0 = seg * kSeg;
  const int n = (int)(M - j0 < kSeg ? M - j0 : kSeg);
  const bool has_before = j0 > 0, has_after = j0 + n < M;

  load_chunk<CPL>(slab, swg, j0, n, W, 0, W < CW ? W : CW);
  cp_async_commit();
  if (tid < n) ids[tid] = sidx[j0 + tid];
  if (tid == kSeg && has_before) edge[0] = sidx[j0 - 1];
  if (tid == kSeg + 1 && has_after) edge[1] = sidx[j0 + n];
  __syncthreads();

  const int n_runs = run_starts(ids, n, starts, warp_runs);
  const bool entered = has_before && edge[0] == ids[0];
  const bool leaves = has_after && edge[1] == ids[n - 1];
  cp_async_wait_all();
  __syncthreads();

  for (int c0 = 0; c0 < W; c0 += CW) {
    const int cw = W - c0 < CW ? W - c0 : CW;
    if (c0 > 0) {
      __syncthreads();  // every warp is done with the last chunk
      load_chunk<CPL>(slab, swg, j0, n, W, c0, cw);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
    }
    // Each warp takes kInFlight runs at a time and finishes them together.
    for (int k0 = warp; k0 < n_runs; k0 += kWarps * kInFlight) {
      float s[kInFlight][CPL], s2[kInFlight][CPL];
      int rows[kInFlight];
#pragma unroll
      for (int b = 0; b < kInFlight; ++b) {
        const int k = k0 + b * kWarps;
        rows[b] = -1;
#pragma unroll
        for (int q = 0; q < CPL; ++q) s[b][q] = s2[b][q] = 0.0f;
        if (k >= n_runs) continue;
        const int p0 = starts[k], p1 = starts[k + 1];
        const int r = ids[p0];
        if (r < 0 || r >= R) continue;  // a masked run
        for (int p = p0; p < p1; ++p) {
          const float* g_row = slab + p * CW;
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            if (lane + 32 * q < cw) {
              const float g = g_row[lane + 32 * q];
              // __fmul_rn keeps g*g a rounded product (no FMA contraction).
              s[b][q] += rounded<kBf16>(g);
              s2[b][q] += rounded<kBf16>(__fmul_rn(g, g));
            }
          }
        }
        const bool head = k == 0 && entered;
        const bool tail = k == n_runs - 1 && leaves;
        if (head || tail) {
          float* out = part + (seg * 2 + (head ? 0 : 1)) * 2LL * W + c0;
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            const int c = lane + 32 * q;
            if (c < cw) {
              out[c] = s[b][q];
              out[W + c] = s2[b][q];
            }
          }
        } else {
          rows[b] = r;
        }
      }
      finish(rows, c0, cw, lane, s, s2);
    }
  }
}

// Adds, in order, partials first, first + step, ... < n_parts of the run
// that starts in segment `seg` and leaves it, at columns [c0, c0 + cw) of
// (sum wg | sum wg^2).  Partial 0 is that segment's leaving run (slot 1),
// partial p > 0 the run entering segment seg + p (slot 0).
template <int CPL>
__device__ __forceinline__ void sum_partials(const float* part, long long seg,
                                             long long first, int step,
                                             long long n_parts, int W, int c0,
                                             int cw, int lane,
                                             float (&s)[1][CPL],
                                             float (&s2)[1][CPL]) {
#pragma unroll
  for (int q = 0; q < CPL; ++q) s[0][q] = s2[0][q] = 0.0f;
#pragma unroll 4
  for (long long p = first; p < n_parts; p += step) {
    const float* row =
        part + (p == 0 ? seg * 2 + 1 : (seg + p) * 2) * 2LL * W + c0;
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      const int c = lane + 32 * q;
      if (c < cw) {
        s[0][q] += row[c];
        s2[0][q] += row[W + c];
      }
    }
  }
}

// The partials of row r's run that leaves segment `seg`, counted by the whole
// block: 1 for the segment itself, then one for each later segment that
// begins with r (a prefix, since sidx is sorted).  Every thread calls it.
__device__ __forceinline__ long long count_partials(const int* sidx, long long seg,
                                                    long long n_seg, int r) {
  long long n_parts = 1;
  for (long long base = seg + 1;; base += kThreads) {
    const long long t = base + threadIdx.x;
    const int hits = __syncthreads_count(t < n_seg && sidx[t * kSeg] == r);
    n_parts += hits;
    if (hits < kThreads) return n_parts;
  }
}

// Pass B for segments blockIdx.x * kWarps + warp.
template <int CPL, typename Finish>
__device__ __forceinline__ void combine_pass(const Finish& finish,
                                             const int* __restrict__ sidx,
                                             const float* __restrict__ part,
                                             long long M, int R, int W) {
  constexpr int CW = 32 * CPL;
  __shared__ float red[2][kWarps][CW];
  __shared__ long long long_seg[kWarps];
  __shared__ int long_row[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n_seg = (M + kSeg - 1) / kSeg;
  const long long seg = (long long)blockIdx.x * kWarps + warp;
  float s[1][CPL], s2[1][CPL];
  if (lane == 0) long_seg[warp] = -1;
  if (seg < n_seg - 1) {
    // The last id of the segment, the one after it and the one before the
    // segment, loaded together.
    const long long end = (seg + 1) * kSeg;
    const int r = sidx[end - 1], next = sidx[end];
    const int prev = sidx[seg > 0 ? seg * kSeg - 1 : 0];
    if (r >= 0 && r < R && next == r && !(seg > 0 && prev == r)) {
      // This segment owns a leaving run.  Lane l votes on whether segment
      // seg + 1 + l begins with r: the hits are a prefix (sidx is sorted).
      const long long t = seg + 1 + lane;
      const unsigned hits =
          __ballot_sync(0xffffffffu, t < n_seg && sidx[t * kSeg] == r);
      if (hits == 0xffffffffu) {  // more than 32 partials: the whole block's
        if (lane == 0) {
          long_seg[warp] = seg;
          long_row[warp] = r;
        }
      } else {  // at most 32 partials: this warp adds them in order
        const int rows[1] = {r};
        for (int c0 = 0; c0 < W; c0 += CW) {
          const int cw = W - c0 < CW ? W - c0 : CW;
          sum_partials<CPL>(part, seg, 0, 1, 1 + __popc(hits), W, c0, cw, lane, s, s2);
          finish(rows, c0, cw, lane, s, s2);
        }
      }
    }
  }
  __syncthreads();
  // Runs of more than 32 partials, one after another with the whole block:
  // warp w adds partials w, w + 8, ... in order, then the eight warp sums are
  // added in warp order.
  for (int lw = 0; lw < kWarps; ++lw) {
    const long long lseg = long_seg[lw];
    if (lseg < 0) continue;
    const int rows[1] = {long_row[lw]};
    const long long n_parts = count_partials(sidx, lseg, n_seg, rows[0]);
    for (int c0 = 0; c0 < W; c0 += CW) {
      const int cw = W - c0 < CW ? W - c0 : CW;
      sum_partials<CPL>(part, lseg, warp, kWarps, n_parts, W, c0, cw, lane, s, s2);
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        red[0][warp][lane + 32 * q] = s[0][q];
        red[1][warp][lane + 32 * q] = s2[0][q];
      }
      __syncthreads();
      if (warp == 0) {
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          s[0][q] = red[0][0][lane + 32 * q];
          s2[0][q] = red[1][0][lane + 32 * q];
          for (int w = 1; w < kWarps; ++w) {
            s[0][q] += red[0][w][lane + 32 * q];
            s2[0][q] += red[1][w][lane + 32 * q];
          }
        }
        finish(rows, c0, cw, lane, s, s2);
      }
      __syncthreads();
    }
  }
}

// The segments of M touches: pass A's grid, and the scratch's first extent.
inline long long segments(long long M) { return (M + kSeg - 1) / kSeg; }

// Pass B's grid: one warp for each segment but the last (0 when M <= kSeg).
inline long long combine_blocks(long long M) {
  return (segments(M) - 1 + kWarps - 1) / kWarps;
}

// What both launchers refuse: a width that is not a multiple of 4, a
// gradient pointer off a 16-byte boundary (the slab is staged with 16-byte
// copies), and a scratch sized for another M.
inline bool bad_launch(const float* swg, long long M, int W, long long part_segments) {
  return W % 4 != 0 || reinterpret_cast<std::uintptr_t>(swg) % 16 != 0 ||
         part_segments != segments(M);
}

// The lane-column template for width W: 32 * CPL columns a chunk.
inline int cols_per_lane(int W) {
  const int cols = (W + 31) / 32;
  return cols < kMaxCols ? cols : kMaxCols;
}

}  // namespace segmented
