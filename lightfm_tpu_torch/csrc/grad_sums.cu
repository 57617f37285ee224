// Per-row gradient sums over sorted touches for Hopper (sm_90a).
//
// Replaces lightfm_tpu/ops/pallas_update.py:365 (sorted_grad_sums_pallas, body
// _sums_kernel :311, worklist _build_worklist :165).  Contract: for the
// non-decreasing touch rows `sidx` [M] and gradients `swg` [M, W],
//     out[r, :W] = sum(wg)      out[r, W:] = sum(wg * wg)
// over the touches of each row r in [0, n_rows), with duplicates summed, rows
// outside [0, n_rows) ignored and untouched rows exactly 0.  At bf16 precision
// every wg and wg*wg (computed in fp32) is rounded to bf16, nearest even,
// before the fp32 sum: the TPU's DEFAULT-precision one-hot matmul.  It is the
// accumulation phase of the adagrad update kernel (csrc/adagrad_update.cu)
// without the apply step, and feeds the hybrid training path's aggregated
// feature update.
//
// Design.  The output is zeroed with a memset on the caller's stream, then a
// segmented reduction over the sorted runs writes the touched rows: each warp
// takes kChunk touch positions and owns every run of equal row ids that STARTS
// in its chunk (i == 0 or sidx[i] != sidx[i-1]), walking that run to its end
// even past the chunk.  Its lanes stride the W columns (up to 32 * kMaxCols per
// pass, so W = 72 is one pass of 3 columns a lane) and sum in fp32 in touch
// order.  No two warps write one row and no atomics are used, so two launches
// are bitwise equal.
//
// Bound on the card: bytes.  The call reads 4*M*(W+1) bytes of touches and
// writes the whole [n_rows, 2W] output, 8*W*n_rows bytes: at the hybrid step's
// M = 131072, W = 72, n_rows = 100000 about 0.029 ms at 3.35 TB/s, most of it
// the output.  As in the update kernel, a hot row's run is walked by one warp,
// so the longest run, not the bytes, sets the time on skewed touches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kChunk = 16;   // touch positions a warp scans for run starts
constexpr int kMaxCols = 4;  // columns a lane holds per pass (128 per warp)

template <bool kBf16>
__device__ __forceinline__ float rounded(float x) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

template <int CPL, bool kBf16>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sorted_grad_sums_kernel(float* __restrict__ out, const int* __restrict__ sidx,
                        const float* __restrict__ swg, long long M, int R,
                        int W) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long begin = warp * kChunk;
  if (begin >= M) return;
  const long long end = begin + kChunk < M ? begin + kChunk : M;

  for (long long i = begin; i < end; ++i) {
    const int r = sidx[i];
    if (r < 0 || r >= R) continue;            // sentinel touch
    if (i > 0 && sidx[i - 1] == r) continue;  // run owned by an earlier warp
    long long stop = i + 1;
    while (stop < M && sidx[stop] == r) ++stop;

    float* orow = out + (size_t)r * 2 * W;
    for (int c0 = 0; c0 < W; c0 += 32 * CPL) {
      float s[CPL], s2[CPL];
#pragma unroll
      for (int k = 0; k < CPL; ++k) s[k] = s2[k] = 0.0f;
      for (long long j = i; j < stop; ++j) {
        const float* g_row = swg + (size_t)j * W;
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          const int c = c0 + lane + 32 * k;
          if (c < W) {
            const float g = g_row[c];
            // __fmul_rn keeps g*g a rounded product (no FMA contraction).
            s[k] += rounded<kBf16>(g);
            s2[k] += rounded<kBf16>(__fmul_rn(g, g));
          }
        }
      }
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int c = c0 + lane + 32 * k;
        if (c < W) {
          orow[c] = s[k];
          orow[W + c] = s2[k];
        }
      }
    }
  }
}

template <int CPL>
cudaError_t launch(float* out, const int* sidx, const float* swg, long long M,
                   int R, int W, bool bf16, cudaStream_t stream) {
  const long long warps = (M + kChunk - 1) / kChunk;
  const unsigned blocks =
      (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const int threads = kWarpsPerBlock * 32;
  if (bf16) {
    sorted_grad_sums_kernel<CPL, true><<<blocks, threads, 0, stream>>>(
        out, sidx, swg, M, R, W);
  } else {
    sorted_grad_sums_kernel<CPL, false><<<blocks, threads, 0, stream>>>(
        out, sidx, swg, M, R, W);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* grad_sums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out: f32 [R, 2W] (every element written: zeros, then the touched rows);
// sidx: i32 [M] non-decreasing; swg: f32 [M, W].  bf16 != 0 rounds wg and
// wg*wg to bf16 before summing.  Returns a cudaError_t code.
int sorted_grad_sums_launch(float* out, const int* sidx, const float* swg,
                            long long M, int R, int W, int bf16, void* stream) {
  if (R <= 0 || W <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)R * 2 * W * sizeof(float), s);
  if (err != cudaSuccess || M <= 0) return (int)err;
  const int cols = (W + 31) / 32;
  if (cols <= 1) return (int)launch<1>(out, sidx, swg, M, R, W, bf16, s);
  if (cols <= 2) return (int)launch<2>(out, sidx, swg, M, R, W, bf16, s);
  if (cols <= 3) return (int)launch<3>(out, sidx, swg, M, R, W, bf16, s);
  return (int)launch<kMaxCols>(out, sidx, swg, M, R, W, bf16, s);
}

}  // extern "C"
