// The segmented reduction over sorted touches that the adagrad update (K1,
// csrc/adagrad_update.cu) and the gradient sums (K3, csrc/grad_sums.cu)
// share; its pass B, after a pass of run-aligned chunks in place of pass A
// (below the first two passes), also serves the generic step's adagrad pass
// (touch_adagrad_update in csrc/adagrad_update.cu).  The kernels differ only
// in what a finished run does: K1 applies the adagrad step to its table row,
// K3 stores the run's sums.  Each passes that as a `Finish` object:
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
// - Pass B (combine_pass with EdgeRuns).  One warp for each segment but the
//   last.  It returns unless a run starts in its segment and leaves it.
//   Then it votes on the first ids of the next 32 segments: a run of at
//   most 32 partials is added by the warp, in segment order, and finished.  A longer run goes to the whole
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

// The partials of row r's run whose partial p > 0 is headed by position
// base + p * stride, counted by the whole block: 1 for partial 0, then one
// for each later head that holds r (a prefix, since sidx is sorted).  Every
// thread calls it.
__device__ __forceinline__ long long count_partials(const int* sidx, long long base,
                                                    long long stride, long long M, int r) {
  long long n_parts = 1;
  for (long long p = 1;; p += kThreads) {
    const long long t = base + (p + threadIdx.x) * stride;
    const int hits = __syncthreads_count(t < M && sidx[t] == r);
    n_parts += hits;
    if (hits < kThreads) return n_parts;
  }
}

// Pass B's owners.  `owned` is called by every lane of the warp for unit
// `seg` (a segment, or a bucket of kChunk positions): it returns the row of
// the run with partials that this unit owns, or -1, and sets `base` so that
// partial p > 0 of that run is headed by position base + p * kStride.  The
// run's partial p lies in slot 1 of unit seg for p = 0, else in slot 0 of
// unit seg + p.
//
// EdgeRuns (K1, K3): the run that starts in segment seg and leaves it.
struct EdgeRuns {
  static constexpr long long kStride = kSeg;

  __device__ __forceinline__ int owned(const int* sidx, long long seg, long long M, int R,
                                       int, long long& base) const {
    const long long n_seg = (M + kSeg - 1) / kSeg;
    if (seg >= n_seg - 1) return -1;
    // The last id of the segment, the one after it and the one before the
    // segment, loaded together.
    const long long end = (seg + 1) * kSeg;
    const int r = sidx[end - 1], next = sidx[end];
    const int prev = sidx[seg > 0 ? seg * kSeg - 1 : 0];
    base = seg * kSeg;
    return r >= 0 && r < R && next == r && !(seg > 0 && prev == r) ? r : -1;
  }
};

// Pass B for units blockIdx.x * kWarps + warp, one a warp.
template <int CPL, typename Finish, typename Owner = EdgeRuns>
__device__ __forceinline__ void combine_pass(const Finish& finish,
                                             const int* __restrict__ sidx,
                                             const float* __restrict__ part,
                                             long long M, int R, int W,
                                             const Owner& owner = Owner{}) {
  constexpr int CW = 32 * CPL;
  __shared__ float red[2][kWarps][CW];
  __shared__ long long long_seg[kWarps], long_base[kWarps];
  __shared__ int long_row[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long seg = (long long)blockIdx.x * kWarps + warp;
  float s[1][CPL], s2[1][CPL];
  if (lane == 0) long_seg[warp] = -1;
  long long base = 0;
  const int r = owner.owned(sidx, seg, M, R, lane, base);
  if (r >= 0) {
    // Lane l votes on whether partial 1 + l is r's: the hits are a prefix
    // (sidx is sorted).
    const long long t = base + (1 + lane) * Owner::kStride;
    const unsigned hits = __ballot_sync(0xffffffffu, t < M && sidx[t] == r);
    if (hits == 0xffffffffu) {  // more than 32 partials: the whole block's
      if (lane == 0) {
        long_seg[warp] = seg;
        long_base[warp] = base;
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
  __syncthreads();
  // Runs of more than 32 partials, one after another with the whole block:
  // warp w adds partials w, w + 8, ... in order, then the eight warp sums are
  // added in warp order.
  for (int lw = 0; lw < kWarps; ++lw) {
    const long long lseg = long_seg[lw];
    if (lseg < 0) continue;
    const int rows[1] = {long_row[lw]};
    const long long n_parts = count_partials(sidx, long_base[lw], Owner::kStride, M, rows[0]);
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

// ---------------------------------------------------------------------------
// Run-aligned chunks (the adagrad pass of the generic training step,
// csrc/adagrad_update.cu's touch_adagrad_update).  The passes above cut the
// positions at fixed segment edges, so the order in which a row's touches
// are added depends on where its run lands in the sorted array.  Here every
// run is cut into chunks of kChunk touches counted from the run's own first
// touch; each chunk is summed in touch order and a run of several chunks adds
// its chunk sums in pass B's fixed order, which depends on the number of
// chunks alone.  A row's sums then depend only on its own touches, in touch
// order: touches keyed outside [0, R) (a masked touch is keyed R) may lie
// anywhere in the array without changing a bit, and each column is summed on
// its own, so a table split by columns adds as the whole.  The gradients are
// read in place through `order` (sorted position -> touch), with no alignment
// asked of them, so any width W >= 1 works.
//
// Pass A: warp u takes positions [u * kChunk, (u + 1) * kChunk), a bucket.
// It finds where each of its positions' runs starts (the run of its first
// position may start in an earlier bucket: a 32-way search of the sorted
// keys), and takes every chunk that starts in the bucket, one after another:
// the chunk's touches (at most kChunk, read through `order` eight at a time)
// are summed in fp32 in touch order.  A run of one chunk is finished at
// once; otherwise the chunk's sums go to the scratch, the run's first chunk
// to slot 1 of its bucket, a later chunk to slot 0.  A chunk k of a run that
// starts at s begins at s + k * kChunk, in bucket s / kChunk + k, so partial
// p of a run lies where sum_partials looks for it; a bucket holds at most one
// first chunk and one later chunk of runs longer than kChunk.
// Pass B: combine_pass with ChunkRuns, one warp a bucket: the bucket that
// holds the start of a run longer than kChunk adds its partials.

constexpr int kChunk = 32;  // touches of one chunk; pass A's positions a warp

// The position where the run that holds position p0 starts (sorted keys,
// skey[p0] == key), found by the warp in rounds of 32 probes.  Every lane
// calls it and gets the same answer.
__device__ __forceinline__ long long run_start(const int* skey, long long p0, int key,
                                               int lane) {
  long long lo = 0, hi = p0;  // the start lies in [lo, hi]
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long q = lo + lane * step;
    const int n = __popc(__ballot_sync(0xffffffffu, q < hi && skey[q] < key));
    if (n == 0) return lo;  // skey[lo] == key
    const long long top = lo + n * step;  // the first probe that is not below
    lo += (n - 1) * step + 1;
    hi = top < hi ? top : hi;
  }
  return lo;
}

// Pass A for bucket blockIdx.x * kWarps + warp.
template <int CPL, typename Finish>
__device__ __forceinline__ void chunk_pass(const Finish& finish,
                                           const int* __restrict__ skey,
                                           const long long* __restrict__ order,
                                           const float* __restrict__ wg,
                                           float* __restrict__ part, long long M,
                                           int R, int W) {
  constexpr int CW = 32 * CPL;
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long u = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long p0 = u * kChunk;
  if (p0 >= M) return;
  // This bucket's keys and touches, and the next bucket's (a chunk that
  // starts here may end there); R stands for a position past the end.
  const long long pa = p0 + lane, pb = pa + kChunk;
  const int ka = pa < M ? skey[pa] : R, kb = pb < M ? skey[pb] : R;
  const long long oa = pa < M ? order[pa] : 0, ob = pb < M ? order[pb] : 0;
  const int up = __shfl_up_sync(kAll, ka, 1);
  const int prev = lane > 0 ? up : (p0 > 0 ? skey[p0 - 1] : ka);
  const bool valid = pa < M && ka >= 0 && ka < R;
  if (__ballot_sync(kAll, valid) == 0) return;
  const unsigned starts = __ballot_sync(kAll, pa < M && (pa == 0 || ka != prev));
  // The run of lane 0 starts in an earlier bucket when no run starts at lane 0.
  long long before = p0;
  if (!(starts & 1u) && __shfl_sync(kAll, valid, 0)) {
    before = run_start(skey, p0, __shfl_sync(kAll, ka, 0), lane);
  }
  const unsigned upto = starts & (lane == 31 ? kAll : (2u << lane) - 1u);
  const long long rs = upto ? p0 + (31 - __clz(upto)) : before;
  unsigned heads = __ballot_sync(kAll, valid && (pa - rs) % kChunk == 0);
  while (heads) {
    const int h = __ffs(heads) - 1;
    heads &= heads - 1;
    const int r = __shfl_sync(kAll, ka, h);
    const bool first = __shfl_sync(kAll, rs, h) == p0 + h;
    const bool last = __shfl_sync(kAll, kb, h) != r;  // the key kChunk on
    // Touch j of the chunk is at index h + j of this bucket and the next.
    const int i = h + lane;
    const int ja = __shfl_sync(kAll, ka, i & 31), jb = __shfl_sync(kAll, kb, i & 31);
    const long long xa = __shfl_sync(kAll, oa, i & 31), xb = __shfl_sync(kAll, ob, i & 31);
    const long long oj = i < 32 ? xa : xb;
    const int len = __popc(__ballot_sync(kAll, (i < 32 ? ja : jb) == r));
    for (int c0 = 0; c0 < W; c0 += CW) {
      const int cw = W - c0 < CW ? W - c0 : CW;
      float s[1][CPL], s2[1][CPL];
#pragma unroll
      for (int q = 0; q < CPL; ++q) s[0][q] = s2[0][q] = 0.0f;
      for (int j0 = 0; j0 < len; j0 += 8) {
        float g[8][CPL];
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const long long o = __shfl_sync(kAll, oj, (j0 + b) & 31);
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            const int c = lane + 32 * q;
            g[b][q] = j0 + b < len && c < cw ? wg[o * W + c0 + c] : 0.0f;
          }
        }
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          if (j0 + b < len) {
#pragma unroll
            for (int q = 0; q < CPL; ++q) {
              // __fmul_rn keeps g*g a rounded product (no FMA contraction).
              s[0][q] += g[b][q];
              s2[0][q] += __fmul_rn(g[b][q], g[b][q]);
            }
          }
        }
      }
      if (first && last) {
        const int rows[1] = {r};
        finish(rows, c0, cw, lane, s, s2);
      } else {
        float* out = part + (u * 2 + (first ? 1 : 0)) * 2LL * W + c0;
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          const int c = lane + 32 * q;
          if (c < cw) {
            out[c] = s[0][q];
            out[W + c] = s2[0][q];
          }
        }
      }
    }
  }
}

// ChunkRuns: the run longer than kChunk that starts in bucket seg (at most
// one does: it leaves the bucket).  It is the bucket's last run.
struct ChunkRuns {
  static constexpr long long kStride = kChunk;

  __device__ __forceinline__ int owned(const int* skey, long long seg, long long M, int R,
                                       int lane, long long& base) const {
    const long long p = seg * kChunk + lane;
    const int k = p < M ? skey[p] : R;
    const int up = __shfl_up_sync(0xffffffffu, k, 1);
    const int prev = lane > 0 ? up : (p > 0 && p < M ? skey[p - 1] : k);
    const unsigned starts = __ballot_sync(0xffffffffu, p < M && (p == 0 || k != prev));
    if (!starts) return -1;
    const int h = 31 - __clz(starts);
    const int r = __shfl_sync(0xffffffffu, k, h);
    base = seg * kChunk + h;
    if (r < 0 || r >= R || base + kChunk >= M) return -1;
    return skey[base + kChunk] == r ? r : -1;
  }
};

// The buckets of M touches: the scratch's first extent; both passes' grids
// take one warp a bucket.
inline long long chunks(long long M) { return (M + kChunk - 1) / kChunk; }
inline long long chunk_blocks(long long M) { return (chunks(M) + kWarps - 1) / kWarps; }

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
