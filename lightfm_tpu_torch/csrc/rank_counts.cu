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
// Exactness.  Every score is one sequential chain of IEEE fp32 fused
// multiply-adds over the Wa columns in index order, acc = fma(u[k], it[k],
// acc) from acc = 0 ("row_dot's chain").  The ranking path removes each test
// item's self match with an exact "- 1" (lightfm_tpu/ops/ranking.py:396-399),
// which is only right if the test score pair_scores hands to rank_counts is
// bitwise the score rank_counts computes for that item.  So: no split of
// the sum over Wa, no reassociation, no tensor cores (TF32, bf16 and 3xTF32
// all change the bits), and no --use_fast_math (ops/_build.py).
//
// Bound: 2*U*I*Wa fp32 FLOP plus U*I*T compares on the FP32 CUDA cores
// (SM count x 128 lanes x 2 x clock; about 67 TFLOP/s on an H100 SXM), far
// above the bytes moved (the catalog, ~29 MB at 100k x 73, sits in the
// 50 MB L2).  The design keeps the FMA units fed:
//
// - Register tiling.  A block of 128 threads owns 16*TU users (TU = 8, or
//   4 for T > 12 or rows wider than 128) and walks a contiguous range of
//   64-item tiles.  Thread (ug = tid / 8, ig = tid % 8) keeps a TU x 8 tile
//   of scores in registers: users ug*TU.., items ig*4.. and 32 + ig*4.. of
//   the item tile.  Per k it reads TU/4 + 2 float4 from shared memory (the
//   8 threads of a quarter warp read 32 consecutive item floats, and share
//   one user vector) and issues 8*TU FMAs, row k + 1's loads issued before
//   row k's FMAs.  Shared memory hands an SM about 32 floats a clock and
//   its FMA units take 128 a clock, so a thread tile needs >= 4 FMAs per
//   float it loads: 8 x 8 gives 4 (a 4 x 8 tile gives 2.7 and left the
//   FMA units waiting on shared memory).  Each accumulator gets exactly one
//   FMA per k, in k order: the outer-product tile keeps row_dot's chain.
// - k-major operands.  The wrapper hands over u_aug.T [Wa, ldu] and
//   items_aug.T [Wa, ldi] (ldu, ldi = U, I rounded up to 4, zero columns),
//   so a tile is Wa rows of contiguous, 16-byte-aligned floats.  The item
//   tile is staged in chunks of at most 80 k-rows, double-buffered with
//   16-byte cp.async.cg (zero-filled past ldi through cp.async's src-size),
//   so the next chunk's copy overlaps this chunk's FMAs.  The user tile is
//   loaded once per block and stays resident while two blocks of it fit on
//   an SM; at wider rows (stream_u, from Wa = 281 at t_pad 32) its chunks are
//   staged beside the item chunks, in the same two buffers' turns, so a
//   block's shared memory no longer grows with Wa and any width runs.  The
//   accumulators stay in registers across the chunks of a tile either way,
//   so every score is still row_dot's chain.  At Wa = 73, T = 10 a block
//   takes 80,896 bytes of shared memory and 219 registers a thread: two
//   blocks per SM.
// - Counting.  After a tile's last chunk each thread compares its 8*TU
//   scores with its users' thresholds (padded with +inf to TP, a multiple
//   of 4, or TP = 1, 2), read from shared memory as float4, into int32
//   counters kept in registers for the whole walk: a compare and an add
//   per (score, slot), a third of the FMA count at Wa = 73, T = 10.  Items
//   past I score NaN and never count; -inf pad rows are ordinary rows.
// - A catalog split fills the card at any U.  The grid is (user tiles,
//   item splits), planned by ops/rank_counts.py::launch_plan.  At the end
//   the 8 threads that share a user (neighbouring lanes) sum their counters
//   with warp shuffles and one lane atomicAdds each sum into counts zeroed
//   by the wrapper.  Integer addition is associative, so two launches are
//   bitwise equal.
//
// pair_scores keeps the same chain, acc = fma(u[k], it[k], acc) over k in
// order from 0, one thread per (user, slot) pair.  Bound: the bytes, each
// user row and each distinct gathered catalog row read once and the scores
// written once (U = 50,000, C = 10, Wa = 73: 44 MB, 0.0142 ms at 3.35 TB/s).
// That bound is out of reach of any order of the pairs that does not group
// them by item: every gathered row crosses the L2 once per pair (10
// sectors, 160 MB there).  A thread that walked its two rows straight from
// global memory (the first version) had the 32 lanes of a warp read 32
// rows 4*Wa bytes apart on every k.  Here a block owns 128 consecutive
// pairs of the flat [U, C] output (so any C runs, and the users it touches
// are consecutive, at most ceil(127 / C) + 1) and stages their gathered
// item rows, then its users' rows, into shared memory, one warp per row
// with its lanes on consecutive floats, eight rows' loads a warp in flight
// before their stores.  Rows sit `stride` floats apart, stride a multiple
// of 4 with stride / 4 odd, so a thread reads its two rows as float4 and
// the 8 threads of each quarter warp hit 8 different 16-byte bank groups.
// Tried on the card and dropped (PERF.md §6): staging by 4-byte cp.async
// (Wa = W + 1 with W a multiple of 8 is odd, so 16-byte copies never line
// up with a row; no faster); 2 or 4 rows a warp in flight (a quarter and a
// tenth slower); 16 with the users in the same rounds (twice slower);
// walking the catalog in L2-sized slices (twice slower).  A kernel that
// only gathers and sums the same rows, a warp a row, is no faster than
// this one (tools/torch_kernel_probe.py --gather): the L2's rate for 4-byte
// loads of rows 4*Wa bytes apart sets the time.  Wide rows are staged in
// chunks of at most 80 columns, the chain carried across them in a
// register; NaN for an index outside [0, I).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // 16 user groups x 8 item groups
constexpr int kItems = 64;     // catalog rows per item tile
constexpr int kPairs = 128;    // pair_scores: (user, slot) pairs per block
constexpr int kMaxChunk = 80;  // pair_scores: columns of a staged chunk
constexpr int kStageCols = (kMaxChunk + 31) / 32;  // floats a lane stages a row
constexpr int kStage = 8;      // rows whose loads a warp starts together

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Row k of the resident user tile (this thread's TU users) and of the
// staged item chunk (its items ig*4.. and 32 + ig*4..).
template <int TU>
__device__ __forceinline__ void load_k(const float* a_s, const float* b_s, int k,
                                       float (&a)[TU], float (&b)[8]) {
#pragma unroll
  for (int i = 0; i < TU; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(a_s + k * 16 * TU + i);
    a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
  }
  const float4 b0 = *reinterpret_cast<const float4*>(b_s + k * kItems);
  const float4 b1 = *reinterpret_cast<const float4*>(b_s + k * kItems + 32);
  b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
  b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
}

// uT [Wa, ldu] and itT [Wa, ldi] are k-major; ts and counts [U, T]
// row-major.  Block (x, y) owns users [x*BU, x*BU + BU) and item tiles
// [y*tiles_per_split, (y+1)*tiles_per_split); kc is the staged chunk's
// k-rows; stream_u stages the user tile chunk by chunk with the items.
template <int TU, int TP>
__global__ void __launch_bounds__(kThreads, 2)
rank_counts_kernel(const float* __restrict__ uT, const float* __restrict__ itT,
                   const float* __restrict__ ts, int* __restrict__ counts,
                   int U, int ldu, int I, int ldi, int Wa, int T, int kc,
                   int tiles_per_split, int stream_u) {
  constexpr int BU = 16 * TU;
  extern __shared__ __align__(16) float smem[];
  float* ts_s = smem;             // [BU, TP]
  float* u_s = ts_s + BU * TP;    // [Wa, BU] resident, [2, kc, BU] streamed
  float* it_s = u_s + (stream_u ? 2 * kc : Wa) * BU;  // [2, kc, kItems]

  const int tid = threadIdx.x;
  const int ig = tid & 7;
  const int ug = tid >> 3;
  const int u0 = blockIdx.x * BU;
  const int n_tiles = (I + kItems - 1) / kItems;
  const int tile0 = blockIdx.y * tiles_per_split;
  const int tile1 = min(tile0 + tiles_per_split, n_tiles);
  const int n_chunks = (Wa + kc - 1) / kc;
  const int n_steps = max(0, tile1 - tile0) * n_chunks;

  // Stage chunk q (item tile tile0 + q / n_chunks, k-rows from
  // (q % n_chunks) * kc) into buffer q & 1, with the users' k-rows when
  // they stream.
  auto stage = [&](int q) {
    const int k0 = (q % n_chunks) * kc;
    const int rows = min(kc, Wa - k0);
    const int col0 = (tile0 + q / n_chunks) * kItems;
    float* dst = it_s + (q & 1) * kc * kItems;
    for (int x = tid; x < rows * (kItems / 4); x += kThreads) {
      const int r = x >> 4;
      const int c = (x & 15) * 4;
      const bool in = col0 + c < ldi;
      const float* src = in ? itT + (size_t)(k0 + r) * ldi + col0 + c : itT;
      cp_async16(dst + r * kItems + c, src, in ? 16 : 0);
    }
    if (stream_u) {
      float* udst = u_s + (q & 1) * kc * BU;
      for (int x = tid; x < rows * (BU / 4); x += kThreads) {
        const int r = x / (BU / 4);
        const int c = (x - r * (BU / 4)) * 4;
        const bool in = u0 + c < ldu;
        const float* src = in ? uT + (size_t)(k0 + r) * ldu + u0 + c : uT;
        cp_async16(udst + r * BU + c, src, in ? 16 : 0);
      }
    }
  };

  if (n_steps > 0) stage(0);
  cp_async_commit();

  for (int x = tid; x < BU * TP; x += kThreads) {
    const int r = x / TP, t = x - r * TP;
    ts_s[x] = (u0 + r < U && t < T) ? ts[(size_t)(u0 + r) * T + t] : INFINITY;
  }
  if (!stream_u) {
    for (int x = tid; x < Wa * BU; x += kThreads) {
      const int k = x / BU, c = x - k * BU;
      u_s[x] = (u0 + c < U) ? uT[(size_t)k * ldu + u0 + c] : 0.0f;
    }
  }

  float acc[TU][8];
  int cnt[TU][TP];
#pragma unroll
  for (int i = 0; i < TU; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll
    for (int t = 0; t < TP; ++t) cnt[i][t] = 0;
  }

  for (int q = 0; q < n_steps; ++q) {
    if (q + 1 < n_steps) stage(q + 1);
    cp_async_commit();
    cp_async_wait_1();  // chunk q has landed (this thread's copies)
    __syncthreads();    // ... and everyone's; u_s and ts_s too

    const int chunk = q % n_chunks;
    const int k0 = chunk * kc;
    const int rows = min(kc, Wa - k0);
    const float* a_s = (stream_u ? u_s + (q & 1) * kc * BU : u_s + k0 * BU) + ug * TU;
    const float* b_s = it_s + (q & 1) * kc * kItems + ig * 4;
    float a[TU], b[8];
    load_k<TU>(a_s, b_s, 0, a, b);
#pragma unroll 4
    for (int k = 0; k < rows; ++k) {
      float an[TU], bn[8];  // row k + 1's operands load under row k's FMAs
      load_k<TU>(a_s, b_s, min(k + 1, rows - 1), an, bn);
#pragma unroll
      for (int i = 0; i < TU; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < TU; ++i) a[i] = an[i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = bn[j];
    }

    if (chunk == n_chunks - 1) {  // the tile's scores are complete
      const int base = (tile0 + q / n_chunks) * kItems;
      if (base + kItems > I) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int item = base + (j < 4 ? ig * 4 + j : 32 + ig * 4 + (j - 4));
          if (item >= I) {
#pragma unroll
            for (int i = 0; i < TU; ++i) acc[i][j] = NAN;  // compares false
          }
        }
      }
#pragma unroll
      for (int i = 0; i < TU; ++i) {
        const float* th = ts_s + (ug * TU + i) * TP;
        if constexpr (TP % 4 == 0) {
#pragma unroll
          for (int t4 = 0; t4 < TP; t4 += 4) {
            const float4 v = *reinterpret_cast<const float4*>(th + t4);
            const float tv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int t = 0; t < 4; ++t) {
#pragma unroll
              for (int j = 0; j < 8; ++j) cnt[i][t4 + t] += acc[i][j] >= tv[t];
            }
          }
        } else {
#pragma unroll
          for (int t = 0; t < TP; ++t) {
            const float tv = th[t];
#pragma unroll
            for (int j = 0; j < 8; ++j) cnt[i][t] += acc[i][j] >= tv;
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      }
    }
    __syncthreads();  // buffer q & 1 is free for chunk q + 2
  }

  // The 8 threads of a user group are lanes 8g..8g+7 of one warp.
#pragma unroll
  for (int i = 0; i < TU; ++i) {
#pragma unroll
    for (int t = 0; t < TP; ++t) {
      int v = cnt[i][t];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      cnt[i][t] = v;
    }
  }
#pragma unroll
  for (int e = 0; e < TU * TP; ++e) {
    if ((e & 7) != ig) continue;
    const int i = e / TP, t = e - i * TP;
    const int u = u0 + ug * TU + i;
    if (u < U && t < T) atomicAdd(counts + (size_t)u * T + t, cnt[i][t]);
  }
}

// Stage rows 0 .. n - 1 of a block's operand (row r from row(r), a pointer
// to its chunk's first float, or nullptr for nothing) into dst, rows `stride`
// floats apart: warp w takes rows w * kStage .., lanes on consecutive floats,
// the loads of kStage rows started before their stores.
template <typename RowFn>
__device__ __forceinline__ void stage_rows(float* dst, int stride, int n,
                                           int cols, RowFn row) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r0 = warp * kStage; r0 < n; r0 += (kPairs / 32) * kStage) {
    float v[kStage][kStageCols];
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const float* src = r0 + j < n ? row(r0 + j) : nullptr;
#pragma unroll
      for (int q = 0; q < kStageCols; ++q) {
        const int c = lane + 32 * q;
        v[j][q] = (src != nullptr && c < cols) ? __ldg(src + c) : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      if (r0 + j >= n) break;
#pragma unroll
      for (int q = 0; q < kStageCols; ++q) {
        const int c = lane + 32 * q;
        if (c < cols) dst[(r0 + j) * stride + c] = v[j][q];
      }
    }
  }
}

// Block x owns the kPairs flat pairs [x * kPairs, x * kPairs + kPairs) of
// the row-major [U, C] output, so the users it touches are consecutive.
// Per chunk of kc <= kMaxChunk columns it stages the gathered item row of
// each pair, then each user row once, `stride` floats apart (stride / 4
// odd: 16-byte aligned rows, and 8 threads reading a float4 each at the same
// k hit 8 different 16-byte bank groups); then each thread carries its
// pair's FMA chain through the chunk, four columns a shared-memory load.
__global__ void __launch_bounds__(kPairs)
pair_scores_kernel(const float* __restrict__ u_aug,
                   const float* __restrict__ items_aug,
                   const int* __restrict__ idx, float* __restrict__ out, int U,
                   int C, int I, int Wa, int kc, int stride) {
  extern __shared__ __align__(16) float ps_smem[];
  int* ids_s = reinterpret_cast<int*>(ps_smem);  // [kPairs]
  float* it_s = ps_smem + kPairs;                // [kPairs, stride]
  float* u_s = it_s + kPairs * stride;           // [users, stride]
  const int tid = threadIdx.x;
  const long long x0 = (long long)blockIdx.x * kPairs;
  const int n_pairs = (int)min((long long)kPairs, (long long)U * C - x0);
  const long long u0 = x0 / C;
  const int n_users = (int)((x0 + n_pairs - 1) / C - u0) + 1;
  const bool live = tid < n_pairs;
  const int item = live ? idx[x0 + tid] : -1;
  const bool in = item >= 0 && item < I;
  const int my_u = live ? (int)((x0 + tid) / C - u0) : 0;
  ids_s[tid] = in ? item : -1;
  __syncthreads();

  float acc = 0.0f;
  for (int k0 = 0; k0 < Wa; k0 += kc) {
    const int cols = min(kc, Wa - k0);
    stage_rows(it_s, stride, n_pairs, cols, [&](int r) -> const float* {
      const int i = ids_s[r];  // -1: the pair scores NaN, nothing to stage
      return i < 0 ? nullptr : items_aug + (size_t)i * Wa + k0;
    });
    stage_rows(u_s, stride, n_users, cols, [&](int r) -> const float* {
      return u_aug + (size_t)(u0 + r) * Wa + k0;
    });
    __syncthreads();
    if (live && in) {
      const float* a = u_s + my_u * stride;
      const float* b = it_s + tid * stride;
      int k = 0;
      for (; k + 4 <= cols; k += 4) {
        const float4 av = *reinterpret_cast<const float4*>(a + k);
        const float4 bv = *reinterpret_cast<const float4*>(b + k);
        acc = __fmaf_rn(av.x, bv.x, acc);
        acc = __fmaf_rn(av.y, bv.y, acc);
        acc = __fmaf_rn(av.z, bv.z, acc);
        acc = __fmaf_rn(av.w, bv.w, acc);
      }
      for (; k < cols; ++k) acc = __fmaf_rn(a[k], b[k], acc);
    }
    __syncthreads();  // the buffers are free for the next chunk
  }
  if (live) out[x0 + tid] = in ? acc : NAN;
}

template <int TU, int TP>
cudaError_t launch_counts(const float* uT, const float* itT, const float* ts,
                          int* counts, int U, int ldu, int I, int ldi, int Wa,
                          int T, int kc, int stream_u, int user_tiles,
                          int item_splits, int tiles_per_split,
                          cudaStream_t stream) {
  constexpr int BU = 16 * TU;
  // The layout ops/rank_counts.py::kernel_shape plans with.
  const size_t u_rows = stream_u ? 2 * (size_t)kc : (size_t)Wa;
  const size_t bytes =
      sizeof(float) * ((size_t)BU * TP + u_rows * BU + 2 * (size_t)kc * kItems);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rank_counts_kernel<TU, TP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)user_tiles, (unsigned)item_splits);
  rank_counts_kernel<TU, TP><<<grid, kThreads, bytes, stream>>>(
      uT, itT, ts, counts, U, ldu, I, ldi, Wa, T, kc, tiles_per_split, stream_u);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rank_counts_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// uT [Wa, ldu] (ldu % 4 == 0, ldu >= U), itT [Wa, ldi] (ldi % 4 == 0,
// ldi >= I), ts/counts [U, T].  block_users and t_pad pick the template (128
// users, TU = 8, with t_pad in {1, 2, 4, 8, 12}; 64 users, TU = 4, with t_pad
// in {16, ..., 32}); stream_u != 0 stages the user tile in chunks of kc
// k-rows instead of keeping it resident; the grid is user_tiles x
// item_splits, each split tiles_per_split 64-item tiles.  Blocks add into
// counts, which must hold zeros.  Returns a cudaError_t code.
int rank_counts_launch(const float* uT, const float* itT, const float* ts,
                       int* counts, int U, int ldu, int I, int ldi, int Wa,
                       int T, int block_users, int t_pad, int kc, int stream_u,
                       int user_tiles, int item_splits, int tiles_per_split,
                       void* stream) {
  if (U <= 0 || T <= 0) return 0;
  const bool ok = I >= 0 && Wa > 0 && ldu >= U && ldu % 4 == 0 && ldi >= I &&
                  ldi % 4 == 0 && t_pad >= T &&
                  kc > 0 && kc <= Wa && user_tiles > 0 && item_splits > 0 &&
                  (long long)user_tiles * block_users >= U &&
                  (long long)item_splits * tiles_per_split * kItems >= I;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RC_CASE(TU, TP)                                                      \
  if (block_users == 16 * (TU) && t_pad == (TP))                             \
    return (int)launch_counts<TU, TP>(uT, itT, ts, counts, U, ldu, I, ldi,   \
                                      Wa, T, kc, stream_u, user_tiles,       \
                                      item_splits, tiles_per_split, s);
  RC_CASE(8, 1) RC_CASE(8, 2) RC_CASE(8, 4) RC_CASE(8, 8) RC_CASE(8, 12)
  RC_CASE(4, 16) RC_CASE(4, 20) RC_CASE(4, 24) RC_CASE(4, 28) RC_CASE(4, 32)
#undef RC_CASE
  return (int)cudaErrorInvalidValue;
}

// u_aug [U, Wa], items_aug [I, Wa], idx and out [U, C], all row-major.  kc
// columns a staged chunk, rows `stride` floats apart (>= kc, 4 x odd), as
// ops/rank_counts.py::pair_plan plans them.  Returns a cudaError_t code.
int pair_scores_launch(const float* u_aug, const float* items_aug,
                       const int* idx, float* out, int U, int C, int I, int Wa,
                       int kc, int stride, void* stream) {
  const long long n = (long long)U * C;
  if (n == 0) return 0;
  if (U < 0 || C < 0 || Wa <= 0 || kc <= 0 || kc > Wa || kc > kMaxChunk ||
      stride < kc || stride % 8 != 4) {
    return (int)cudaErrorInvalidValue;
  }
  // A block's pairs span at most this many consecutive users.
  const long long span = (kPairs + C - 2) / C + 1LL;
  const long long users = span < kPairs ? span : kPairs;
  const size_t bytes = sizeof(float) * (kPairs + (kPairs + users) * (size_t)stride);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pair_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (n + kPairs - 1) / kPairs;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  pair_scores_kernel<<<(unsigned)blocks, kPairs, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      u_aug, items_aug, idx, out, U, C, I, Wa, kc, stride);
  return (int)cudaGetLastError();
}

}  // extern "C"
