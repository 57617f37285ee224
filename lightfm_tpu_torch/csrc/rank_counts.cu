// Fused catalog scoring + rank counting for Hopper (sm_90a), and the pair
// scorer that must agree with it bit for bit.
//
// Replaces the TPU kernel lightfm_tpu/ops/pallas_rank.py:63
// (rank_counts_fused, body _rank_count_kernel :37) and the MXU diagonal
// GEMM lightfm_tpu/ops/ranking.py:293 (_diag_scores).
//
//   rank_counts: counts[u, t] = #{i < I : dot(u_aug[u], items_aug[i]) >= ts[u, t]}
//   pair_scores: out[u, c]    = dot(u_aug[u], items_aug[idx[u, c]])
//
// Both entry points score through the one __device__ routine row_dot: a
// sequential chain of IEEE fp32 fused multiply-adds over the Wa columns in
// index order.  The ranking path removes each test item's self match with
// an exact "- 1" (lightfm_tpu/ops/ranking.py:396-399), which is only right
// if the test score handed to rank_counts is bitwise the score rank_counts
// computes for that item; a single routine in a single translation unit,
// built without --use_fast_math, guarantees that.  No tensor cores: TF32 or
// bf16 products would break the exact ">=" tie semantics.
//
// Bound: 2*U*I*Wa fp32 FLOP plus U*I*T compares on the FP32 CUDA cores
// (SM count x 128 lanes x 2 x clock; about 67 TFLOP/s on an H100 SXM), far
// above the bytes moved (the catalog, ~29 MB at 100k x 73, sits in the
// 50 MB L2).  This first design is the simple one: each block owns a tile
// of 32 users (one per lane) and walks the whole catalog in item tiles
// staged in shared memory; each warp takes every 8th item of a tile.  Both
// operands are read from shared memory for every FMA (the item row as a
// broadcast, the user row conflict-free through an odd row stride), so the
// kernel is bound by shared-memory issue, not by the FMA rate.  Register
// tiling of the user rows is the next step.
//
// Counts are int32 per thread, reduced across the 8 warps through shared
// memory with no atomics, so results are deterministic.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kUsers = 32;   // users per block: one per lane
constexpr int kWarps = 8;    // warps per block: item slices
constexpr int kItems = 64;   // catalog rows staged per tile

__device__ __forceinline__ float row_dot(const float* __restrict__ a,
                                         const float* __restrict__ b, int n) {
  float acc = 0.0f;
  for (int k = 0; k < n; ++k) acc = __fmaf_rn(a[k], b[k], acc);
  return acc;
}

template <int TP>
__global__ void __launch_bounds__(kUsers * kWarps)
rank_counts_kernel(const float* __restrict__ u_aug,
                   const float* __restrict__ items_aug,
                   const float* __restrict__ ts, int* __restrict__ counts,
                   int U, int I, int Wa, int T) {
  extern __shared__ float smem[];
  const int ldu = Wa | 1;  // odd stride: lanes hit distinct banks
  float* u_s = smem;                     // [kUsers, ldu]
  float* it_s = smem + kUsers * ldu;     // [kItems, Wa]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int u0 = blockIdx.x * kUsers;
  const int u = u0 + lane;

  for (int x = threadIdx.x; x < kUsers * Wa; x += blockDim.x) {
    const int r = x / Wa, k = x - r * Wa;
    u_s[r * ldu + k] = (u0 + r < U) ? u_aug[(size_t)(u0 + r) * Wa + k] : 0.0f;
  }

  float t_r[TP];
  int c_r[TP];
#pragma unroll
  for (int t = 0; t < TP; ++t) {
    t_r[t] = (u < U && t < T) ? ts[(size_t)u * T + t] : INFINITY;
    c_r[t] = 0;
  }

  const float* my_u = u_s + lane * ldu;
  for (int base = 0; base < I; base += kItems) {
    const int n = min(kItems, I - base);
    __syncthreads();  // previous tile fully consumed (and u_s written)
    const float* src = items_aug + (size_t)base * Wa;
    for (int x = threadIdx.x; x < n * Wa; x += blockDim.x) it_s[x] = src[x];
    __syncthreads();
    for (int j = warp; j < n; j += kWarps) {
      const float s = row_dot(my_u, it_s + j * Wa, Wa);
#pragma unroll
      for (int t = 0; t < TP; ++t) c_r[t] += (s >= t_r[t]) ? 1 : 0;
    }
  }

  __syncthreads();
  int* red = reinterpret_cast<int*>(smem);  // [kWarps, kUsers, TP]
#pragma unroll
  for (int t = 0; t < TP; ++t) red[(warp * kUsers + lane) * TP + t] = c_r[t];
  __syncthreads();
  for (int x = threadIdx.x; x < kUsers * TP; x += blockDim.x) {
    const int r = x / TP, t = x - r * TP;
    if (u0 + r < U && t < T) {
      int sum = 0;
      for (int w = 0; w < kWarps; ++w) sum += red[(w * kUsers + r) * TP + t];
      counts[(size_t)(u0 + r) * T + t] = sum;
    }
  }
}

__global__ void pair_scores_kernel(const float* __restrict__ u_aug,
                                   const float* __restrict__ items_aug,
                                   const int* __restrict__ idx,
                                   float* __restrict__ out, int U, int C, int I,
                                   int Wa) {
  const size_t x = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= (size_t)U * C) return;
  const int u = (int)(x / C);
  const int i = idx[x];
  out[x] = (i >= 0 && i < I)
               ? row_dot(u_aug + (size_t)u * Wa, items_aug + (size_t)i * Wa, Wa)
               : NAN;
}

template <int TP>
cudaError_t launch_counts(const float* u_aug, const float* items_aug,
                          const float* ts, int* counts, int U, int I, int Wa,
                          int T, cudaStream_t stream) {
  const size_t tiles = (size_t)(kUsers * (Wa | 1) + kItems * Wa) * sizeof(float);
  const size_t red = (size_t)kWarps * kUsers * TP * sizeof(int);
  const size_t bytes = tiles > red ? tiles : red;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rank_counts_kernel<TP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (U + kUsers - 1) / kUsers;
  rank_counts_kernel<TP><<<blocks, kUsers * kWarps, bytes, stream>>>(
      u_aug, items_aug, ts, counts, U, I, Wa, T);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rank_counts_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// T <= 32 (the ranking path's COUNT_T_LIMIT); returns a cudaError_t code.
int rank_counts_launch(const float* u_aug, const float* items_aug,
                       const float* ts, int* counts, int U, int I, int Wa,
                       int T, void* stream) {
  if (U <= 0 || T <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 1) return launch_counts<1>(u_aug, items_aug, ts, counts, U, I, Wa, T, s);
  if (T <= 2) return launch_counts<2>(u_aug, items_aug, ts, counts, U, I, Wa, T, s);
  if (T <= 4) return launch_counts<4>(u_aug, items_aug, ts, counts, U, I, Wa, T, s);
  if (T <= 8) return launch_counts<8>(u_aug, items_aug, ts, counts, U, I, Wa, T, s);
  if (T <= 16) return launch_counts<16>(u_aug, items_aug, ts, counts, U, I, Wa, T, s);
  if (T <= 32) return launch_counts<32>(u_aug, items_aug, ts, counts, U, I, Wa, T, s);
  return (int)cudaErrorInvalidValue;
}

int pair_scores_launch(const float* u_aug, const float* items_aug,
                       const int* idx, float* out, int U, int C, int I, int Wa,
                       void* stream) {
  const size_t n = (size_t)U * C;
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  pair_scores_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      u_aug, items_aug, idx, out, U, C, I, Wa);
  return (int)cudaGetLastError();
}

}  // extern "C"
