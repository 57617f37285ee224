// Feature sums and candidate scores for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's feature sums
// (lightfm_tpu/ops/representation.py:22, batch_representation) are XLA's
// gather and sum.  Added because the port's PyTorch composition of the same
// sums wrote every candidate's feature rows to device memory before summing
// them: at the warp-hybrid-l2 training step (N = 11 x 131,072 candidates,
// P = 8 slots, W = 32, a 2,048-row table of 256 KB) a [N, P, W] gather of
// 1.47 GB written and read again, then the scores' [C, B, W] product, ~370
// MB more: two thirds of the step.
//
// Contract: for candidate ids `ids` [N] into padded feature rows `idx`,
// `wts` [R, P] (padding slots hold weight 0) over `table` [F, W],
//     reps[n, :] = sum_p fl(wts[ids[n], p] * scale) * table[idx[ids[n], p], :]
// in slot order with fp32 fused multiply-adds (a slot of weight 0 adds an
// exact 0 and is not read).  `scale` is read from device memory when given
// (the lazy-L2 scale, no host sync), else `scale_value`.  With `users`
// [B, W] and N = C * B (candidate n belongs to batch row n % B, slot-major),
//     scores[n] = sum_{c < W-1} users[b, c] * reps[n, c] + reps[n, W-1] + users[b, W-1]
// with the dot's terms taken in a fixed order inside the warp: the user's
// bias slot counts as 1, so the item bias folds in.  An id outside [0, R)
// or a feature id outside [0, F) yields NaN instead of reading out of
// bounds.
//
// Bound on the card: bytes.  The least a scoring step must move is each
// candidate's real feature ids and weights, the users' rows and the table
// once: ~52 MB at the hybrid cell's step, ~15 us at 3.35 TB/s.  This design
// also writes reps (4 * N * W bytes: 184 MB, ~55 us at that shape), from
// which the step picks its positive and violator rows, and reads each
// candidate's padded slots (6.4 MB of feature rows, L2-resident); the table
// rows come from L1 and L2.
//
// Design: a group of G lanes takes one batch row b and walks that row's C
// candidates, so its user row is read from device memory once.  The group's
// lanes run over the columns, V at a time (one 16-byte load a lane where W is
// a multiple of 4 and the rows are 16-byte aligned: G = 8 lanes and four
// candidates a warp at W = 32; else single floats and G = 32), 32 * CPL
// columns a pass, more passes for a wider W, so a table row is one coalesced
// read of 128-byte lines through the read-only cache.  A candidate's P ids
// and weights are loaded by the group's lanes, G slots at a time, and
// broadcast with __shfl_sync; a ballot ends the slot loop after the last slot
// of non-zero weight in any group of the warp (pad_csr's padding trails a
// row's features), and the table rows of kUnroll slots are loaded together
// before their multiply-adds, so a warp keeps several loads in flight.  The
// candidates' ids are loaded G at a time by the group's lanes.  No atomics
// and no shared memory: every sum's order depends only on the shapes, so two
// launches are bitwise equal.  (One warp a candidate with single floats took
// 0.44 ms at the hybrid step on an H100 SXM at 700 W: its per-candidate
// shuffles, ballot and reduction, paid by 32 lanes for 32 columns, bound it.)

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 4;  // columns of 32 a group covers per pass
constexpr int kUnroll = 4;   // slots whose table rows are loaded together
constexpr unsigned kFull = 0xffffffffu;

template <int V>
__device__ __forceinline__ void load_vec(float (&out)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = t.x;
    out[1] = t.y;
    out[2] = t.z;
    out[3] = t.w;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) out[e] = __ldg(p + e);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = v[e];
  }
}

// G lanes a batch row, V columns a load, CPL loads a lane per pass
// (G * V * CPL = 32 * CPL columns a pass).
template <int G, int V, int CPL>
__global__ void __launch_bounds__(kThreads)
feature_sums_kernel(float* __restrict__ reps, float* __restrict__ scores,
                    const float* __restrict__ table, const int* __restrict__ idx,
                    const float* __restrict__ wts, const int* __restrict__ ids,
                    const float* __restrict__ users, const float* __restrict__ scale,
                    float scale_value, long long B, int C, int P, int W, int R, int F) {
  constexpr int kPass = G * V * CPL;
  static_assert(kPass % 32 == 0 && 32 % G == 0 && G % kUnroll == 0, "group layout");
  const int lane = threadIdx.x & 31;
  const int gl = lane % G;  // this lane within its group
  const long long b = ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
  if (__all_sync(kFull, b >= B)) return;  // the whole warp past the last row
  const bool active = b < B;
  const float s = scale != nullptr ? __ldg(scale) : scale_value;
  const float* u = users != nullptr ? users + b * W : nullptr;
  const float nan = __int_as_float(0x7fc00000);
  const unsigned group_bits = (unsigned)((1ull << G) - 1ull);
  const int last_gl = ((W - 1) / V) % G;  // the group lane holding column W - 1
  int lane_id = -1;
  for (int c = 0; c < C; ++c) {
    if (c % G == 0) {
      lane_id = active && c + gl < C ? __ldg(ids + (long long)(c + gl) * B + b) : -1;
    }
    const long long n = (long long)c * B + b;
    const int id = __shfl_sync(kFull, lane_id, c % G, G);
    const bool row_ok = (unsigned)id < (unsigned)R;
    float part = 0.f;    // this lane's terms of the user dot
    float last = 0.f;    // reps[n, W-1] in its lane
    float u_last = 0.f;  // users[b, W-1] in its lane
    for (int c0 = 0; c0 < W; c0 += kPass) {
      float acc[CPL][V];
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
#pragma unroll
        for (int e = 0; e < V; ++e) acc[q][e] = 0.f;
      }
      for (int p0 = 0; p0 < P; p0 += G) {
        int t = 0;
        float w = 0.f;
        if (row_ok && p0 + gl < P) {
          const size_t at = (size_t)id * P + p0 + gl;
          t = __ldg(idx + at);
          w = __ldg(wts + at) * s;
        }
        const unsigned live = (__ballot_sync(kFull, w != 0.f) >> (lane - gl)) & group_bits;
        const int n_live = 32 - __clz(live);
        const int n_max = (int)__reduce_max_sync(kFull, (unsigned)n_live);
        for (int j = 0; j < n_max; j += kUnroll) {
          float wk[kUnroll];
          float v[kUnroll][CPL][V];
#pragma unroll
          for (int k = 0; k < kUnroll; ++k) {
            wk[k] = __shfl_sync(kFull, w, j + k, G);
            const int tk = __shfl_sync(kFull, t, j + k, G);
            if (j + k >= n_live) wk[k] = 0.f;
            const bool feat_ok = (unsigned)tk < (unsigned)F;
#pragma unroll
            for (int q = 0; q < CPL; ++q) {
              const int col = c0 + (gl + G * q) * V;
#pragma unroll
              for (int e = 0; e < V; ++e) v[k][q][e] = 0.f;
              if (wk[k] != 0.f && col < W) {
                if (feat_ok) {
                  load_vec<V>(v[k][q], table + (size_t)tk * W + col);
                } else {
#pragma unroll
                  for (int e = 0; e < V; ++e) v[k][q][e] = nan;
                }
              }
            }
          }
#pragma unroll
          for (int k = 0; k < kUnroll; ++k) {
#pragma unroll
            for (int q = 0; q < CPL; ++q) {
#pragma unroll
              for (int e = 0; e < V; ++e) acc[q][e] = fmaf(wk[k], v[k][q][e], acc[q][e]);
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int col = c0 + (gl + G * q) * V;
        if (!active || col >= W) continue;
        if (!row_ok) {
#pragma unroll
          for (int e = 0; e < V; ++e) acc[q][e] = nan;
        }
        store_vec<V>(reps + n * W + col, acc[q]);
        if (u != nullptr) {
          float uv[V];
          load_vec<V>(uv, u + col);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            if (col + e < W - 1) {
              part = fmaf(uv[e], acc[q][e], part);
            } else if (col + e == W - 1) {
              last = acc[q][e];
              u_last = uv[e];
            }
          }
        }
      }
    }
    if (u != nullptr) {
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) part += __shfl_xor_sync(kFull, part, off, G);
      const float rep_last = __shfl_sync(kFull, last, last_gl, G);
      const float bias = __shfl_sync(kFull, u_last, last_gl, G);
      if (active && gl == 0) scores[n] = (part + rep_last) + bias;
    }
  }
}

template <int G, int V, int CPL>
cudaError_t launch(float* reps, float* scores, const float* table, const int* idx,
                   const float* wts, const int* ids, const float* users, const float* scale,
                   float scale_value, long long B, int C, int P, int W, int R, int F,
                   cudaStream_t stream) {
  const unsigned blocks = (unsigned)((B * G + kThreads - 1) / kThreads);
  feature_sums_kernel<G, V, CPL><<<blocks, kThreads, 0, stream>>>(
      reps, scores, table, idx, wts, ids, users, scale, scale_value, B, C, P, W, R, F);
  return cudaGetLastError();
}

template <int G, int V>
cudaError_t launch_cols(float* reps, float* scores, const float* table, const int* idx,
                        const float* wts, const int* ids, const float* users,
                        const float* scale, float scale_value, long long B, int C, int P, int W,
                        int R, int F, cudaStream_t st) {
  const int cols = (W + 31) / 32;
  switch (cols < kMaxCols ? cols : kMaxCols) {
    case 1: return launch<G, V, 1>(reps, scores, table, idx, wts, ids, users, scale,
                                   scale_value, B, C, P, W, R, F, st);
    case 2: return launch<G, V, 2>(reps, scores, table, idx, wts, ids, users, scale,
                                   scale_value, B, C, P, W, R, F, st);
    case 3: return launch<G, V, 3>(reps, scores, table, idx, wts, ids, users, scale,
                                   scale_value, B, C, P, W, R, F, st);
    default: return launch<G, V, kMaxCols>(reps, scores, table, idx, wts, ids, users, scale,
                                           scale_value, B, C, P, W, R, F, st);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

const char* feature_sums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// reps: f32 [C * B, W]; scores: f32 [C, B], or null when users is null;
// table: f32 [F, W]; idx: i32 [R, P]; wts: f32 [R, P]; ids: i32 [C * B];
// users: f32 [B, W] or null (then C must be 1); scale: a device f32, or null
// to use scale_value.  All contiguous.  One launch on the caller's stream:
// 16-byte loads where W % 4 == 0 and table, reps and users are 16-byte
// aligned, else single floats; returns a cudaError_t code.
int feature_sums_launch(float* reps, float* scores, const float* table, const int* idx,
                        const float* wts, const int* ids, const float* users,
                        const float* scale, float scale_value, long long B, int C, int P,
                        int W, int R, int F, void* stream) {
  if (B <= 0 || C <= 0 || W <= 0) return 0;
  if (P < 0 || R < 0 || F < 0 || (users == nullptr && C != 1) ||
      (users != nullptr && scores == nullptr) || B > (0x7fffffffLL * kThreads) / 32) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W % 4 == 0 && aligned16(table) && aligned16(reps) && (users == nullptr || aligned16(users))) {
    return (int)launch_cols<8, 4>(reps, scores, table, idx, wts, ids, users, scale,
                                  scale_value, B, C, P, W, R, F, st);
  }
  return (int)launch_cols<32, 1>(reps, scores, table, idx, wts, ids, users, scale, scale_value,
                                 B, C, P, W, R, F, st);
}

}  // extern "C"
