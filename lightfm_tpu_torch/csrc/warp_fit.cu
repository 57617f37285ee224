// Whole-fit WARP + adagrad training in one launch, for Hopper (sm_90a).
//
// Replaces lightfm_tpu/ops/pallas_train.py:174 (warp_fit_fused, body
// _train_kernel :53).  Contract, per step s of the S pre-shuffled batches, in
// order (identity features, alpha = 0):
//   - example b is (uid, iid, y, weight, valid) = batches[s, 0..4, b] (y and
//     weight are float bit patterns);
//   - candidate k of example b is negatives[s, 0, k*B + b]; the selected
//     negative is the first k, in order, whose score beats the positive's
//     score minus 1 and that is not in the user's positives row;
//   - loss L = min(weight * log(max(1, floor((n_items-1)/(k+1)))), max_loss)
//     where an update happens (valid & y > 0 & found), else 0;
//   - items: -L*u1 at the positive, +L*u1 at the selected negative; users:
//     L*[n_rep - p_rep | 1] (u1 is the user row with its bias slot set to 1);
//     duplicates summed, both tables moved by adagrad with the PRE-step
//     accumulator: table -= lr * rsqrt(acc) * sum(g), acc += sum(g * g).
// The four state arrays are updated in place; rows no update touches are
// never written.  Gathers are exact fp32 reads (the interpret-mode semantics
// of the TPU kernel, whose one-hot matmuls are exact there).
//
// Design.  One persistent thread block of 32 warps walks the steps; the
// tables stay in device memory, which the L2 cache holds at the sizes this
// entry point is for (a few MB).  Each step has three phases separated by
// __syncthreads():
//   1. forward: a warp per example (lanes stride the W columns, dot products
//      reduced across the warp and broadcast from lane 0, so every lane takes
//      the same branch) scans the K candidates in order and stops at the first
//      hit; the membership test strides the positives row across the lanes.
//      It writes the example's item gradient L*u1 and user gradient to scratch
//      and one sort key per nonzero touch: (side, row, position).
//   2. a block-wide bitonic sort of the step's 3B keys (in shared memory when
//      they fit), so each touched row's contributions form one run in a fixed
//      order;
//   3. K1's segmented reduction (csrc/adagrad_update.cu): a warp owns each run
//      and sums it in fp32 in key order, then applies adagrad to that row.
// No float atomics, so two launches are bitwise equal.
//
// Bound on the card: the steps are sequential, each depending on the tables
// the previous one wrote, so the fit is a chain of S dependent steps; within
// a step the work is a few hundred bytes per example (K+1 candidate rows of W
// floats, read from L2).  Measured against the bytes bound it is far from it:
// one block uses one of the 132 SMs and each step pays three block-wide
// barriers' worth of latency.  A cooperative multi-block grid is the way to
// speed; this version is right first.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 4;  // columns a lane holds (W <= 128)
constexpr unsigned long long kEmpty = ~0ull;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return __shfl_sync(0xffffffffu, x, 0);  // lane 0's value, on every lane
}

__device__ __forceinline__ unsigned long long touch_key(unsigned side, int row,
                                                        unsigned pos) {
  return ((unsigned long long)side << 63) |
         ((unsigned long long)(unsigned)row << 32) | pos;
}

__global__ void __launch_bounds__(kThreads)
warp_fit_kernel(float* u_tab, float* u_acc, float* i_tab, float* i_acc,
                const int* __restrict__ batches,
                const int* __restrict__ negatives,
                const int* __restrict__ positives, int S, int B, int K, int W,
                int P, float n_items_m1, float lr, float max_loss, float* lu,
                float* gu, unsigned long long* gkeys, int N, int keys_in_smem) {
  extern __shared__ unsigned long long smem_keys[];
  unsigned long long* keys = keys_in_smem ? smem_keys : gkeys;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int s = 0; s < S; ++s) {
    const int* bt = batches + (size_t)s * 8 * B;
    const int* ng = negatives + (size_t)s * K * B;

    // ---- 1. forward: one warp per example ------------------------------
    for (int b = warp; b < B; b += kWarps) {
      const int uid = bt[b];
      const int iid = bt[B + b];
      const float y = __int_as_float(bt[2 * B + b]);
      const float wt = __int_as_float(bt[3 * B + b]);
      const bool valid = bt[4 * B + b] > 0;
      const float* urow = u_tab + (size_t)uid * W;
      const float* prow = i_tab + (size_t)iid * W;
      float u1[kMaxCols], pr[kMaxCols];
      float part = 0.0f;
#pragma unroll
      for (int q = 0; q < kMaxCols; ++q) {
        const int c = lane + 32 * q;
        u1[q] = 0.0f;
        pr[q] = 0.0f;
        if (c < W) {
          u1[q] = c == W - 1 ? 1.0f : urow[c];
          pr[q] = prow[c];
          part = fmaf(u1[q], pr[q], part);
        }
      }
      const float u_bias = urow[W - 1];
      const float pos_pred = warp_sum(part) + u_bias;

      bool found = false;
      int j_sel = 0, neg = 0;
      for (int k = 0; k < K && !found; ++k) {
        const int nk = ng[k * B + b];
        const float* nrow = i_tab + (size_t)nk * W;
        float np = 0.0f;
#pragma unroll
        for (int q = 0; q < kMaxCols; ++q) {
          const int c = lane + 32 * q;
          if (c < W) np = fmaf(u1[q], nrow[c], np);
        }
        const float npred = warp_sum(np) + u_bias;
        if (npred > pos_pred - 1.0f) {  // uniform: npred is lane 0's sum
          bool hit_pos = false;
          const int* prw = positives + (size_t)uid * P;
          for (int p = lane; p < P; p += 32) hit_pos |= prw[p] == nk;
          if (!__any_sync(0xffffffffu, hit_pos)) {
            found = true;
            j_sel = k;
            neg = nk;
          }
        }
      }
      float L = 0.0f;
      if (valid && y > 0.0f && found) {
        const float sampled = (float)(j_sel + 1);
        const float rank_w = logf(fmaxf(1.0f, floorf(n_items_m1 / sampled)));
        L = fminf(wt * rank_w, max_loss);
      }
      const float* nrow = i_tab + (size_t)neg * W;
#pragma unroll
      for (int q = 0; q < kMaxCols; ++q) {
        const int c = lane + 32 * q;
        if (c < W) {
          lu[(size_t)b * W + c] = L * u1[q];
          gu[(size_t)b * W + c] = L * (c == W - 1 ? 1.0f : nrow[c] - pr[q]);
        }
      }
      if (lane == 0) {
        // Zero-loss examples add exact zeros: they take no touch at all.
        const bool on = L != 0.0f;
        keys[b] = on ? touch_key(0, iid, b) : kEmpty;
        keys[B + b] = on ? touch_key(0, neg, B + b) : kEmpty;
        keys[2 * B + b] = on ? touch_key(1, uid, b) : kEmpty;
      }
    }
    for (int i = 3 * B + tid; i < N; i += kThreads) keys[i] = kEmpty;
    __syncthreads();

    // ---- 2. bitonic sort of the step's touch keys -------------------------
    for (int k = 2; k <= N; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < N; i += kThreads) {
          const int x = i ^ j;
          if (x > i) {
            const unsigned long long a = keys[i], c = keys[x];
            if ((a > c) == ((i & k) == 0)) {
              keys[i] = c;
              keys[x] = a;
            }
          }
        }
        __syncthreads();
      }
    }

    // ---- 3. segmented sums over the sorted runs, then adagrad ------------
    for (int i = warp; i < N; i += kWarps) {
      const unsigned long long key = keys[i];
      if (key == kEmpty) break;  // sorted: only empties follow
      const unsigned long long head = key >> 32;
      if (i > 0 && (keys[i - 1] >> 32) == head) continue;  // not a run start
      int stop = i + 1;
      while (stop < N && (keys[stop] >> 32) == head) ++stop;
      const bool user = (key >> 63) != 0;
      const int row = (int)(head & 0x7fffffffu);
      float* tab = (user ? u_tab : i_tab) + (size_t)row * W;
      float* acc = (user ? u_acc : i_acc) + (size_t)row * W;
#pragma unroll
      for (int q = 0; q < kMaxCols; ++q) {
        const int c = lane + 32 * q;
        if (c >= W) continue;
        float g1 = 0.0f, g2 = 0.0f;
        for (int t = i; t < stop; ++t) {
          const unsigned pos = (unsigned)(keys[t] & 0xffffffffu);
          float g;
          if (user) {
            g = gu[(size_t)pos * W + c];
          } else if (pos < (unsigned)B) {
            g = -lu[(size_t)pos * W + c];  // the positive item
          } else {
            g = lu[(size_t)(pos - B) * W + c];  // the selected negative
          }
          g1 += g;
          g2 += __fmul_rn(g, g);
        }
        const float a = acc[c];
        tab[c] = __fsub_rn(tab[c], __fmul_rn(__fmul_rn(lr, rsqrtf(a)), g1));
        acc[c] = a + g2;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

const char* warp_fit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Keys of one step fit in shared memory up to this many (128 KB).
int warp_fit_smem_key_capacity() { return 16384; }

// u_tab, u_acc: f32 [U, W]; i_tab, i_acc: f32 [I, W] (updated in place);
// batches: i32 [S, 8, B]; negatives: i32 [S, 1, K*B]; positives: i32 [U, P];
// lu, gu: f32 [B, W] scratch; keys: u64 [N] scratch (unused when the keys fit
// in shared memory), N a power of two >= 3B.  W <= 128.  Returns a
// cudaError_t code.
int warp_fit_launch(float* u_tab, float* u_acc, float* i_tab, float* i_acc,
                    const int* batches, const int* negatives,
                    const int* positives, int S, int B, int K, int W, int P,
                    int n_items, float lr, float max_loss, float* lu, float* gu,
                    unsigned long long* keys, int N, void* stream) {
  if (S <= 0 || B <= 0) return 0;
  if (W <= 0 || W > 32 * kMaxCols || N < 3 * B || (N & (N - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int in_smem = N <= warp_fit_smem_key_capacity();
  const size_t smem = in_smem ? (size_t)N * sizeof(unsigned long long) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      warp_fit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  warp_fit_kernel<<<1, kThreads, smem, s>>>(
      u_tab, u_acc, i_tab, i_acc, batches, negatives, positives, S, B, K, W, P,
      (float)(n_items - 1), lr, max_loss, lu, gu, keys, N, in_smem);
  return (int)cudaGetLastError();
}

}  // extern "C"
