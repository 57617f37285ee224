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
// Design: the two-pass segmented reduction of csrc/segmented.cuh (pass A
// sums each 64-touch segment's runs from a cp.async slab, pass B adds the
// partial rows of the runs that cross segment edges in a fixed order, no
// atomics), whose finished runs this file applies: the table and acc rows of
// a warp's kInFlight runs are loaded together before any is written, and
// pass B applies a crossing run with the untouched pre-call acc.
//
// touch_adagrad_update, the second entry point, is the adagrad pass of the
// generic training step (ops/updates.py's sparse_update on the card).  It
// replaces the XLA scatter-adds of lightfm_tpu/ops/updates.py:43
// (sparse_update), no Pallas kernel; the port first ran them as PyTorch's
// index_put_(accumulate=True), which sums each row's duplicates in one
// thread's serial loop: at a row width of 32 a hot tag's ~65,000 touches a
// step took that loop twice (table and acc), 58-67% of a hybrid step's device
// time.  Contract: K1's at fp32, over touches keyed by row (a masked touch
// keyed R, past the last row), sorted stably, with the gradients read in
// place through the sort's order; any width.  Bound: bytes, as K1's: the
// active touches' ids, order and gradient rows read once and the distinct
// rows' table and acc read and written once (0.04-0.08 ms a hybrid step's
// item touches).  Design: segmented.cuh's run-aligned chunks: a row's sums
// depend only on its own touches in touch order, so the masked touches of a
// row partition and the columns of a component partition leave a held row's
// result bitwise the one device's; a hot row's touches are summed 32 to a
// warp, and its chunk sums added in pass B's fixed order (by one warp up to
// 32 of them, else by a block of 8 warps), so a run of n touches costs about
// n / 256 dependent adds instead of n.

#include "segmented.cuh"

namespace {

using namespace segmented;

// The adagrad step on columns [c0, c0 + cw) of NR rows (a row < 0 is
// skipped), from their sums; this lane takes columns c0 + lane + 32 * q.
// Every row's acc and table are loaded before any is written, so the NR
// rows' loads are in flight together.
struct AdagradStep {
  float* table;
  float* acc;
  int W;
  float lr;

  template <int NR, int CPL>
  __device__ __forceinline__ void operator()(const int (&rows)[NR], int c0, int cw,
                                             int lane, const float (&s)[NR][CPL],
                                             const float (&s2)[NR][CPL]) const {
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
};

template <int CPL, bool kBf16>
__global__ void __launch_bounds__(kThreads)
adagrad_segment_pass(float* __restrict__ table, float* __restrict__ acc,
                     const int* __restrict__ sidx,
                     const float* __restrict__ swg, float* __restrict__ part,
                     long long M, int R, int W, float lr) {
  segment_pass<CPL, kBf16>(AdagradStep{table, acc, W, lr}, sidx, swg, part, M, R, W);
}

template <int CPL>
__global__ void __launch_bounds__(kThreads)
adagrad_combine_pass(float* __restrict__ table, float* __restrict__ acc,
                     const int* __restrict__ sidx,
                     const float* __restrict__ part, long long M, int R, int W,
                     float lr) {
  combine_pass<CPL>(AdagradStep{table, acc, W, lr}, sidx, part, M, R, W);
}

template <int CPL>
cudaError_t launch(float* table, float* acc, const int* sidx, const float* swg,
                   float* part, long long M, int R, int W, float lr, bool bf16,
                   cudaStream_t stream) {
  const unsigned blocks = (unsigned)segments(M);
  if (bf16) {
    adagrad_segment_pass<CPL, true><<<blocks, kThreads, 0, stream>>>(
        table, acc, sidx, swg, part, M, R, W, lr);
  } else {
    adagrad_segment_pass<CPL, false><<<blocks, kThreads, 0, stream>>>(
        table, acc, sidx, swg, part, M, R, W, lr);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || combine_blocks(M) == 0) return err;
  adagrad_combine_pass<CPL><<<(unsigned)combine_blocks(M), kThreads, 0, stream>>>(
      table, acc, sidx, part, M, R, W, lr);
  return cudaGetLastError();
}

// touch_adagrad_update: the same step over run-aligned chunks (segmented.cuh),
// gradients read in place through the sort's order.
template <int CPL>
__global__ void __launch_bounds__(kThreads)
adagrad_chunk_pass(float* __restrict__ table, float* __restrict__ acc,
                   const int* __restrict__ skey, const long long* __restrict__ order,
                   const float* __restrict__ wg, float* __restrict__ part, long long M,
                   int R, int W, float lr) {
  chunk_pass<CPL>(AdagradStep{table, acc, W, lr}, skey, order, wg, part, M, R, W);
}

template <int CPL>
__global__ void __launch_bounds__(kThreads)
adagrad_chunk_combine(float* __restrict__ table, float* __restrict__ acc,
                      const int* __restrict__ skey, const float* __restrict__ part,
                      long long M, int R, int W, float lr) {
  combine_pass<CPL>(AdagradStep{table, acc, W, lr}, skey, part, M, R, W, ChunkRuns{});
}

template <int CPL>
cudaError_t launch_chunks(float* table, float* acc, const int* skey, const long long* order,
                          const float* wg, float* part, long long M, int R, int W, float lr,
                          cudaStream_t stream) {
  const unsigned blocks = (unsigned)chunk_blocks(M);
  adagrad_chunk_pass<CPL><<<blocks, kThreads, 0, stream>>>(table, acc, skey, order, wg, part,
                                                           M, R, W, lr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  adagrad_chunk_combine<CPL><<<blocks, kThreads, 0, stream>>>(table, acc, skey, part, M, R, W,
                                                              lr);
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
  if (bad_launch(swg, M, W, part_segments)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cols_per_lane(W)) {
    case 1: return (int)launch<1>(table, acc, sidx, swg, part, M, R, W, lr, bf16, s);
    case 2: return (int)launch<2>(table, acc, sidx, swg, part, M, R, W, lr, bf16, s);
    case 3: return (int)launch<3>(table, acc, sidx, swg, part, M, R, W, lr, bf16, s);
    default: return (int)launch<kMaxCols>(table, acc, sidx, swg, part, M, R, W, lr, bf16, s);
  }
}

// table, acc: f32 [R, W] (updated in place), any W >= 1; skey: i32 [M]
// non-decreasing, a key outside [0, R) skipped; order: i64 [M], the touch
// (row of wg) at each sorted position; wg: f32 [M, W] in touch order; part:
// f32 scratch [part_chunks, 2, 2W], written and read only by this call,
// where part_chunks must be ceil(M / kChunk) (kChunk = 32).  fp32 sums.
// Launches two grids of ceil(part_chunks / kWarps) blocks on the caller's
// stream; returns a cudaError_t code.
int touch_adagrad_update_launch(float* table, float* acc, const int* skey,
                                const long long* order, const float* wg, float* part,
                                long long M, int R, int W, float lr, long long part_chunks,
                                void* stream) {
  if (M <= 0 || R <= 0 || W <= 0) return 0;
  if (part_chunks != chunks(M)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // At most 64 columns a pass (wider tables take more passes): the pass-A
  // warp holds eight gradient rows of CPL columns a lane in registers, and
  // at CPL = 4 ptxas spilled.
  if (cols_per_lane(W) == 1) {
    return (int)launch_chunks<1>(table, acc, skey, order, wg, part, M, R, W, lr, s);
  }
  return (int)launch_chunks<2>(table, acc, skey, order, wg, part, M, R, W, lr, s);
}

}  // extern "C"
