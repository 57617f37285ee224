// Per-row gradient sums over sorted touches for Hopper (sm_90a).
//
// Replaces lightfm_tpu/ops/pallas_update.py:365 (sorted_grad_sums_pallas, body
// _sums_kernel :311, worklist _build_worklist :165).  Contract: for the
// non-decreasing touch rows `sidx` [M] and gradients `swg` [M, W],
//     out[r, :W] = sum(wg)      out[r, W:] = sum(wg * wg)
// over the touches of each row r in [0, n_rows), with duplicates summed, rows
// outside [0, n_rows) ignored and untouched rows exactly 0.  At bf16 precision
// every wg and wg*wg (computed in fp32) is rounded to bf16, nearest even,
// before the fp32 sum: the TPU's DEFAULT-precision one-hot matmul.  It feeds
// the hybrid training path's aggregated feature update.
//
// Bound on the card: bytes.  The call reads 4*M*(W+1) bytes of touches and
// writes the whole [n_rows, 2W] output, 8*W*n_rows bytes: at the hybrid step's
// M = 131072, W = 72, n_rows = 100000 about 0.029 ms at 3.35 TB/s, most of it
// the output.  This design writes the touched rows twice (the memset's zeros,
// then the sums): about 0.041 ms of bytes at that shape.
//
// Design: the output is zeroed by a memset on the caller's stream (untouched
// rows are most of the table, and a memset writes them once at the memory's
// rate), then the two-pass segmented reduction of csrc/segmented.cuh
// (pass A sums each 64-touch segment's runs from a cp.async slab, pass B adds
// the partial rows of the runs that cross segment edges in a fixed order, no
// atomics), whose finished runs this file stores: a run's output store waits
// on no load.

#include "segmented.cuh"

namespace {

using namespace segmented;

// Stores the sums of NR rows (a row < 0 is skipped) at columns [c0, c0 + cw)
// of their (sum wg | sum wg^2) output rows; this lane takes columns
// c0 + lane + 32 * q.
struct StoreSums {
  float* out;
  int W;

  template <int NR, int CPL>
  __device__ __forceinline__ void operator()(const int (&rows)[NR], int c0, int cw,
                                             int lane, const float (&s)[NR][CPL],
                                             const float (&s2)[NR][CPL]) const {
#pragma unroll
    for (int b = 0; b < NR; ++b) {
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int c = lane + 32 * q;
        if (rows[b] >= 0 && c < cw) {
          out[(size_t)rows[b] * 2 * W + c0 + c] = s[b][q];
          out[(size_t)rows[b] * 2 * W + W + c0 + c] = s2[b][q];
        }
      }
    }
  }
};

template <int CPL, bool kBf16>
__global__ void __launch_bounds__(kThreads)
grad_sums_segment_pass(float* __restrict__ out, const int* __restrict__ sidx,
                       const float* __restrict__ swg, float* __restrict__ part,
                       long long M, int R, int W) {
  segment_pass<CPL, kBf16>(StoreSums{out, W}, sidx, swg, part, M, R, W);
}

template <int CPL>
__global__ void __launch_bounds__(kThreads)
grad_sums_combine_pass(float* __restrict__ out, const int* __restrict__ sidx,
                       const float* __restrict__ part, long long M, int R, int W) {
  combine_pass<CPL>(StoreSums{out, W}, sidx, part, M, R, W);
}

template <int CPL>
cudaError_t launch(float* out, const int* sidx, const float* swg, float* part,
                   long long M, int R, int W, bool bf16, cudaStream_t stream) {
  const unsigned blocks = (unsigned)segments(M);
  if (bf16) {
    grad_sums_segment_pass<CPL, true><<<blocks, kThreads, 0, stream>>>(
        out, sidx, swg, part, M, R, W);
  } else {
    grad_sums_segment_pass<CPL, false><<<blocks, kThreads, 0, stream>>>(
        out, sidx, swg, part, M, R, W);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || combine_blocks(M) == 0) return err;
  grad_sums_combine_pass<CPL><<<(unsigned)combine_blocks(M), kThreads, 0, stream>>>(
      out, sidx, part, M, R, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* grad_sums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out: f32 [R, 2W] (every element written: zeros, then the touched rows);
// sidx: i32 [M] non-decreasing; swg: f32 [M, W], 16-byte aligned, W % 4 == 0;
// part: f32 scratch [part_segments, 2, 2W], written and read only by this
// call, where part_segments must be ceil(M / kSeg) (kSeg = 64; 0 for M = 0).
// bf16 != 0 rounds wg and wg*wg to bf16 before summing.  Zeroes out, then
// launches ceil(M / kSeg) pass-A blocks and ceil((segments - 1) / kWarps)
// pass-B blocks, all on the caller's stream; returns a cudaError_t code.
int sorted_grad_sums_launch(float* out, const int* sidx, const float* swg,
                            float* part, long long M, int R, int W, int bf16,
                            long long part_segments, void* stream) {
  if (R <= 0 || W <= 0) return 0;
  if (M < 0 || bad_launch(swg, M, W, part_segments)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)R * 2 * W * sizeof(float), s);
  if (err != cudaSuccess || M == 0) return (int)err;
  switch (cols_per_lane(W)) {
    case 1: return (int)launch<1>(out, sidx, swg, part, M, R, W, bf16, s);
    case 2: return (int)launch<2>(out, sidx, swg, part, M, R, W, bf16, s);
    case 3: return (int)launch<3>(out, sidx, swg, part, M, R, W, bf16, s);
    default: return (int)launch<kMaxCols>(out, sidx, swg, part, M, R, W, bf16, s);
  }
}

}  // extern "C"
