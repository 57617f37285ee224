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
//
// Identity rows (identity_scores_kernel): the same contract with one slot of
// weight 1 whose feature is the id itself, for candidates of identity
// features (pure matrix factorisation):
//     reps[n, :] = fl(scale * table[ids[n], :])
//     scores[n]  = sum_{c < W-1} users[b, c] * reps[n, c] + reps[n, W-1] + users[b, W-1]
// with the dot's terms in the order feature_sums_kernel takes them (each
// lane's columns, then a butterfly over the group), so the two kernels agree
// bitwise on a table of one-slot rows.  An id outside [0, R) reads NaN.
// Added because the port's PyTorch composition gathered every candidate's row
// into a [C * B, W] tensor, scaled it in a second pass and wrote a [C, B, W]
// product before summing it: at the warp-kos-adadelta step (C = 10 x 131,072
// candidates twice a step, W = 32) ~1.1 ms a call.  Bound: bytes.  A call
// must read each candidate's id, the users' rows once and the distinct table
// rows once, and write reps (from which the step picks its positive and
// violator rows) and the scores: ~208 MB at that shape, ~62 us at 3.35 TB/s.
// Design: a group of G lanes owns one batch row and keeps its user row in
// registers across the row's C candidates (W up to 96; a wider row is walked
// 96 columns a pass, its user columns loaded again each pass); the group loads the next G
// candidates' ids at once and broadcasts them with __shfl_sync, then loads
// the table rows of U candidates before their multiplies and stores, so a
// group keeps U row loads in flight (one dependent load a candidate would
// make the kernel latency-bound).  No slot loop, no ballot, no atomics, no
// shared memory: two launches are bitwise equal.

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

// A group lane's columns of one pass of row `p` (0 past the row's end or for
// an inactive lane).
template <int G, int V, int CPL>
__device__ __forceinline__ void load_pass(float (&out)[CPL][V], const float* p, int c0, int gl,
                                          int W, bool active) {
#pragma unroll
  for (int q = 0; q < CPL; ++q) {
    const int col = c0 + (gl + G * q) * V;
    if (active && col < W) {
      load_vec<V>(out[q], p + col);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) out[q][e] = 0.f;
    }
  }
}

// G lanes a batch row, V columns a load, CPL loads a lane per pass, the rows
// of U candidates loaded together (about 32 floats a lane in flight).
template <int G, int V, int CPL, int U>
__global__ void __launch_bounds__(kThreads)
identity_scores_kernel(float* __restrict__ reps, float* __restrict__ scores,
                       const float* __restrict__ table, const int* __restrict__ ids,
                       const float* __restrict__ users, const float* __restrict__ scale,
                       float scale_value, long long B, int C, int W, int R) {
  constexpr int kPass = G * V * CPL;
  static_assert(kPass % 32 == 0 && 32 % G == 0 && G % U == 0, "group layout");
  const int lane = threadIdx.x & 31;
  const int gl = lane % G;
  const long long b = ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
  if (__all_sync(kFull, b >= B)) return;
  const bool active = b < B;
  const float s = scale != nullptr ? __ldg(scale) : scale_value;
  const float* u = users + (active ? b : 0) * W;
  const float u_last = active ? __ldg(u + W - 1) : 0.f;
  const float nan = __int_as_float(0x7fc00000);
  const int last_gl = ((W - 1) / V) % G;  // the group lane holding column W - 1
  const bool one_pass = W <= kPass;
  float uv[CPL][V];
  if (one_pass) load_pass<G, V, CPL>(uv, u, 0, gl, W, active);  // held across the C candidates
  int lane_id = -1;
  for (int c = 0; c < C; c += U) {
    if (c % G == 0) {
      lane_id = active && c + gl < C ? __ldg(ids + (long long)(c + gl) * B + b) : -1;
    }
    int id[U];
    float part[U], last[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      id[k] = __shfl_sync(kFull, lane_id, (c + k) % G, G);
      part[k] = 0.f;
      last[k] = 0.f;
    }
    for (int c0 = 0; c0 < W; c0 += kPass) {
      if (!one_pass) load_pass<G, V, CPL>(uv, u, c0, gl, W, active);
      float v[U][CPL][V];
#pragma unroll
      for (int k = 0; k < U; ++k) {
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          const int col = c0 + (gl + G * q) * V;
#pragma unroll
          for (int e = 0; e < V; ++e) v[k][q][e] = 0.f;
          if (active && c + k < C && col < W) {
            if ((unsigned)id[k] < (unsigned)R) {
              load_vec<V>(v[k][q], table + (size_t)id[k] * W + col);
            } else {
#pragma unroll
              for (int e = 0; e < V; ++e) v[k][q][e] = nan;
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          const int col = c0 + (gl + G * q) * V;
          if (!active || c + k >= C || col >= W) continue;
#pragma unroll
          for (int e = 0; e < V; ++e) v[k][q][e] *= s;
          store_vec<V>(reps + ((long long)(c + k) * B + b) * W + col, v[k][q]);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            if (col + e < W - 1) {
              part[k] = fmaf(uv[q][e], v[k][q][e], part[k]);
            } else if (col + e == W - 1) {
              last[k] = v[k][q][e];
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) {
        part[k] += __shfl_xor_sync(kFull, part[k], off, G);
      }
      if (active && c + k < C && gl == last_gl) {
        scores[(long long)(c + k) * B + b] = (part[k] + last[k]) + u_last;
      }
    }
  }
}

template <int G, int V, int CPL>
cudaError_t launch_identity(float* reps, float* scores, const float* table, const int* ids,
                            const float* users, const float* scale, float scale_value,
                            long long B, int C, int W, int R, cudaStream_t stream) {
  constexpr int kU = 32 / (CPL * V) < 8 ? 32 / (CPL * V) : 8;
  const unsigned blocks = (unsigned)((B * G + kThreads - 1) / kThreads);
  identity_scores_kernel<G, V, CPL, kU><<<blocks, kThreads, 0, stream>>>(
      reps, scores, table, ids, users, scale, scale_value, B, C, W, R);
  return cudaGetLastError();
}

template <int G, int V>
cudaError_t launch_identity_cols(float* reps, float* scores, const float* table,
                                 const int* ids, const float* users, const float* scale,
                                 float scale_value, long long B, int C, int W, int R,
                                 cudaStream_t st) {
  // At most 96 columns a pass: ptxas spilled the user row of a 128-column pass.
  switch ((W + 31) / 32) {
    case 1: return launch_identity<G, V, 1>(reps, scores, table, ids, users, scale,
                                            scale_value, B, C, W, R, st);
    case 2: return launch_identity<G, V, 2>(reps, scores, table, ids, users, scale,
                                            scale_value, B, C, W, R, st);
    default: return launch_identity<G, V, 3>(reps, scores, table, ids, users, scale,
                                             scale_value, B, C, W, R, st);
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

// reps: f32 [C * B, W]; scores: f32 [C, B]; table: f32 [R, W]; ids: i32
// [C * B]; users: f32 [B, W]; scale: a device f32, or null to use
// scale_value.  All contiguous.  One launch on the caller's stream: 16-byte
// loads where W % 4 == 0 and table, reps and users are 16-byte aligned, else
// single floats; returns a cudaError_t code.
int identity_scores_launch(float* reps, float* scores, const float* table, const int* ids,
                           const float* users, const float* scale, float scale_value,
                           long long B, int C, int W, int R, void* stream) {
  if (B <= 0 || C <= 0 || W <= 0) return 0;
  if (R < 0 || users == nullptr || scores == nullptr ||
      B > (0x7fffffffLL * kThreads) / 32) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W % 4 == 0 && aligned16(table) && aligned16(reps) && aligned16(users)) {
    return (int)launch_identity_cols<8, 4>(reps, scores, table, ids, users, scale, scale_value,
                                           B, C, W, R, st);
  }
  return (int)launch_identity_cols<32, 1>(reps, scores, table, ids, users, scale, scale_value,
                                          B, C, W, R, st);
}

}  // extern "C"
