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
// Design.  The TPU kernel builds a worklist of (table block, touch chunk)
// pairs and sums duplicates with one-hot MXU matmuls, because XLA:TPU
// serializes duplicate-row scatters.  Here the same contract is a segmented
// reduction over the sorted runs: each warp takes kChunk touch positions and
// owns every run of equal row ids that STARTS in its chunk (i == 0 or
// sidx[i] != sidx[i-1]), walking that run to its end even past the chunk.  Its
// lanes stride the W columns (up to 32 * kMaxCols per pass, so W = 72 is one
// pass of 3 columns a lane) and sum in fp32 in touch order.  No two warps write
// one row and no atomics are used, so two launches are bitwise equal.  Each
// lane reads acc once, then writes table and acc.
//
// Bound on the card: bytes.  The call must read 4*M*(W+1) bytes of touches and
// read and write table and acc for each distinct touched row (16*W bytes a
// row): tens of microseconds at the training step's M = 131072, W = 72 at
// 3.35 TB/s.  The simple design does not reach it on skewed data: a hot row
// with thousands of touches in one batch is one run, so ONE warp walks all of
// them serially while the rest of the card idles (a popular item in a batch of
// 131072).  Splitting long runs across warps with a second, ordered pass is the
// way to speed; this version is right first.

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
sorted_adagrad_kernel(float* __restrict__ table, float* __restrict__ acc,
                      const int* __restrict__ sidx,
                      const float* __restrict__ swg, long long M, int R, int W,
                      float lr) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long begin = warp * kChunk;
  if (begin >= M) return;
  const long long end = begin + kChunk < M ? begin + kChunk : M;

  for (long long i = begin; i < end; ++i) {
    const int r = sidx[i];
    if (r < 0 || r >= R) continue;            // sentinel / masked touch
    if (i > 0 && sidx[i - 1] == r) continue;  // run owned by an earlier warp
    long long stop = i + 1;
    while (stop < M && sidx[stop] == r) ++stop;

    float* trow = table + (size_t)r * W;
    float* arow = acc + (size_t)r * W;
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
          const float a = arow[c];
          const float step = __fmul_rn(__fmul_rn(lr, rsqrtf(a)), s[k]);
          trow[c] = __fsub_rn(trow[c], step);
          arow[c] = a + s2[k];
        }
      }
    }
  }
}

template <int CPL>
cudaError_t launch(float* table, float* acc, const int* sidx, const float* swg,
                   long long M, int R, int W, float lr, bool bf16,
                   cudaStream_t stream) {
  const long long warps = (M + kChunk - 1) / kChunk;
  const unsigned blocks =
      (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const int threads = kWarpsPerBlock * 32;
  if (bf16) {
    sorted_adagrad_kernel<CPL, true><<<blocks, threads, 0, stream>>>(
        table, acc, sidx, swg, M, R, W, lr);
  } else {
    sorted_adagrad_kernel<CPL, false><<<blocks, threads, 0, stream>>>(
        table, acc, sidx, swg, M, R, W, lr);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* adagrad_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// table, acc: f32 [R, W] (updated in place); sidx: i32 [M] non-decreasing;
// swg: f32 [M, W].  bf16 != 0 rounds wg and wg*wg to bf16 before summing.
// Returns a cudaError_t code.
int sorted_adagrad_update_launch(float* table, float* acc, const int* sidx,
                                 const float* swg, long long M, int R, int W,
                                 float lr, int bf16, void* stream) {
  if (M <= 0 || R <= 0 || W <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cols = (W + 31) / 32;
  if (cols <= 1) return (int)launch<1>(table, acc, sidx, swg, M, R, W, lr, bf16, s);
  if (cols <= 2) return (int)launch<2>(table, acc, sidx, swg, M, R, W, lr, bf16, s);
  if (cols <= 3) return (int)launch<3>(table, acc, sidx, swg, M, R, W, lr, bf16, s);
  return (int)launch<kMaxCols>(table, acc, sidx, swg, M, R, W, lr, bf16, s);
}

}  // extern "C"
