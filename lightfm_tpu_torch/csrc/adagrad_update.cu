// Sorted-touch adagrad table update for Hopper (sm_90a).
//
// Replaces lightfm_tpu/ops/pallas_update.py:234 (sorted_adagrad_update_pallas,
// body _update_kernel :67, worklist _build_worklist :165).  Contract: for every
// row r touched by the non-decreasing `sidx`,
//     table[r] -= lr * rsqrt(acc_pre[r]) * sum(wg)      acc[r] += sum(wg * wg)
// with duplicates summed, `acc_pre` read before this call, rows outside
// [0, R) ignored, untouched rows never written, and an all-masked call a no-op.
// The update is in place.  At bf16 precision every wg and wg*wg (computed in
// fp32) is rounded to bf16, nearest even, before the fp32 sum: the TPU's
// DEFAULT-precision one-hot matmul.
//
// Bound on the card: bytes.  The call must read 4*M*(W+1) bytes of touches and
// read and write table and acc once for each distinct touched row (16*W bytes
// a row): 0.037 ms for a training step's item touches (M = 131072, W = 72,
// 73k distinct rows) at 3.35 TB/s.
//
// What held the first design back.  It gave each warp 16 positions and walked
// every run that starts there to its end: a serial scan of `sidx` for the
// run's end, then one gradient row after another, then the table and acc
// rows, each a dependent trip to device memory with a few hundred bytes in
// flight per warp.  Measured on an H100: 0.30 ms on uniform touches whose runs
// are at most 8 long, the same as on a training step's touches (longest run
// 201), so the chain of trips set the time there, not the longest run; a hot
// row added its own serial walk on top (4.98 ms on Zipf touches, 36 ms for
// one run of 131072).
//
// Design: a segmented reduction in two launches, no atomics.
// - Pass A.  The M positions are cut into segments of kSeg.  One block takes
//   one segment: it starts 16-byte cp.async copies of the segment's [kSeg, W]
//   gradient slab into shared memory (in column chunks of 32 * CPL, so any W
//   that is a multiple of 4 fits), finds the run starts of the segment's ids with one ballot per 32
//   positions while the copies fly, then gives the runs to the warps,
//   kInFlight at a time, which sum them from shared memory in fp32, in touch
//   order.  A run that begins and ends inside the segment has this block as
//   its only writer: the warp applies the step at once, with the table and
//   acc rows of its kInFlight runs loaded together before any is written.
//   The run that enters from the segment before, or the one that starts here
//   and leaves into the next, is written instead as a partial (sum wg |
//   sum wg^2) row to the scratch `part` [segments, 2, 2W]: slot 0 for the
//   entering run, slot 1 for the leaving one.
// - Pass B.  One warp for each segment but the last.  It returns unless a
//   run starts in its segment and leaves it.  Then it votes on the first ids
//   of the next 32 segments: a run of at most 32 partials is added by the
//   warp, in segment order, and the step applied with the untouched pre-call
//   acc.  A longer run goes to the whole block, which counts its segments
//   with block-wide votes and adds its partials in a fixed tree: warp w takes
//   partials w, w + 8, ... in order, and the eight warp sums are added in warp
//   order.  A run of n touches costs about n / kSeg partial reads spread over
//   a block instead of n serial trips.
// Every sum's order depends only on the positions, so two launches are
// bitwise equal.  Rows outside [0, R) are skipped in both passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSeg = 64;        // touch positions of one pass-A segment
constexpr int kThreads = 256;   // both passes: 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 4;     // columns a lane holds per chunk (128 a chunk)
constexpr int kInFlight = 2;    // pass-A runs a warp applies at once
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

// The adagrad step on columns [c0, c0 + cw) of NR rows (a row < 0 is
// skipped), from their sums; this lane takes columns c0 + lane + 32 * q.
// Every row's acc and table are loaded before any is written, so the NR
// rows' loads are in flight together.
template <int NR, int CPL>
__device__ __forceinline__ void apply_rows(float* table, float* acc,
                                           const int (&rows)[NR], int W,
                                           int c0, int cw, int lane,
                                           const float (&s)[NR][CPL],
                                           const float (&s2)[NR][CPL],
                                           float lr) {
  float a[NR][CPL], t[NR][CPL];
#pragma unroll
  for (int b = 0; b < NR; ++b) {
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      const int c = lane + 32 * q;
      if (rows[b] >= 0 && c < cw) {
        a[b][q] = acc[(size_t)rows[b] * W + c0 + c];
        t[b][q] = table[(size_t)rows[b] * W + c0 + c];
      }
    }
  }
#pragma unroll
  for (int b = 0; b < NR; ++b) {
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      const int c = lane + 32 * q;
      if (rows[b] >= 0 && c < cw) {
        const float step = __fmul_rn(__fmul_rn(lr, rsqrtf(a[b][q])), s[b][q]);
        table[(size_t)rows[b] * W + c0 + c] = __fsub_rn(t[b][q], step);
        acc[(size_t)rows[b] * W + c0 + c] = a[b][q] + s2[b][q];
      }
    }
  }
}

template <int CPL, bool kBf16>
__global__ void __launch_bounds__(kThreads)
adagrad_segment_pass(float* __restrict__ table, float* __restrict__ acc,
                     const int* __restrict__ sidx,
                     const float* __restrict__ swg, float* __restrict__ part,
                     long long M, int R, int W, float lr) {
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

  // Run starts: one ballot per 32 positions, ranked by a prefix count.
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
  if (tid == 0) starts[n_runs] = n;
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
    // Each warp takes kInFlight runs at a time, so the table and acc rows
    // of all of them are loaded together.
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
      apply_rows<kInFlight, CPL>(table, acc, rows, W, c0, cw, lane, s, s2, lr);
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

template <int CPL>
__global__ void __launch_bounds__(kThreads)
adagrad_combine_pass(float* __restrict__ table, float* __restrict__ acc,
                     const int* __restrict__ sidx,
                     const float* __restrict__ part, long long M, int R, int W,
                     float lr) {
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
          apply_rows<1, CPL>(table, acc, rows, W, c0, cw, lane, s, s2, lr);
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
    long long n_parts = 1;
    for (long long base = lseg + 1;; base += kThreads) {
      const long long t = base + threadIdx.x;
      const int hits = __syncthreads_count(t < n_seg && sidx[t * kSeg] == rows[0]);
      n_parts += hits;
      if (hits < kThreads) break;
    }
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
        apply_rows<1, CPL>(table, acc, rows, W, c0, cw, lane, s, s2, lr);
      }
      __syncthreads();
    }
  }
}

template <int CPL>
cudaError_t launch(float* table, float* acc, const int* sidx, const float* swg,
                   float* part, long long M, int R, int W, float lr, bool bf16,
                   cudaStream_t stream) {
  const long long segments = (M + kSeg - 1) / kSeg;
  const long long combine_blocks = (segments - 1 + kWarps - 1) / kWarps;
  if (bf16) {
    adagrad_segment_pass<CPL, true><<<(unsigned)segments, kThreads, 0, stream>>>(
        table, acc, sidx, swg, part, M, R, W, lr);
  } else {
    adagrad_segment_pass<CPL, false><<<(unsigned)segments, kThreads, 0, stream>>>(
        table, acc, sidx, swg, part, M, R, W, lr);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || combine_blocks == 0) return err;
  adagrad_combine_pass<CPL><<<(unsigned)combine_blocks, kThreads, 0, stream>>>(
      table, acc, sidx, part, M, R, W, lr);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* adagrad_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// table, acc: f32 [R, W] (updated in place); sidx: i32 [M] non-decreasing;
// swg: f32 [M, W], 16-byte aligned, W % 4 == 0; part: f32 scratch
// [part_segments, 2, 2W], written and read only by this call, where
// part_segments must be ceil(M / kSeg) (kSeg = 64).  bf16 != 0 rounds wg and
// wg*wg to bf16 before summing.  Launches ceil(M / kSeg) pass-A blocks and
// then ceil((segments - 1) / kWarps) pass-B blocks on the caller's stream;
// returns a cudaError_t code.
int sorted_adagrad_update_launch(float* table, float* acc, const int* sidx,
                                 const float* swg, float* part, long long M,
                                 int R, int W, float lr, int bf16,
                                 long long part_segments, void* stream) {
  if (M <= 0 || R <= 0 || W <= 0) return 0;
  if (W % 4 != 0 || reinterpret_cast<std::uintptr_t>(swg) % 16 != 0 ||
      part_segments != (M + kSeg - 1) / kSeg) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cols = (W + 31) / 32;
  if (cols <= 1) return (int)launch<1>(table, acc, sidx, swg, part, M, R, W, lr, bf16, s);
  if (cols <= 2) return (int)launch<2>(table, acc, sidx, swg, part, M, R, W, lr, bf16, s);
  if (cols <= 3) return (int)launch<3>(table, acc, sidx, swg, part, M, R, W, lr, bf16, s);
  return (int)launch<kMaxCols>(table, acc, sidx, swg, part, M, R, W, lr, bf16, s);
}

}  // extern "C"
