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
// Design.  One cooperative launch (cudaLaunchCooperativeKernel) of G blocks
// of 16 warps, G no more than can be resident at once (one block an SM by
// default); the tables stay in device memory, which the L2 cache holds at
// the sizes this entry point is for (0.34 MB at 943 x 1,682, W = 16).  The
// steps are sequential (step s reads what step s - 1 wrote), but a step's B
// examples are independent, so each step is two phases across the whole
// grid, each closed by a grid-wide barrier (grid.sync()):
//   1. forward: one warp per example, examples dealt across the blocks
//      (b = warp * G + block).  The batch fields and the first 32 candidate
//      ids load together (one id a lane), then the user, positive and up to
//      16 candidate rows (8 at W > 64) together, so the first compare waits
//      on two trips of the L2, not one per candidate.  Each score is the
//      first version's arithmetic: lane partial FMAs over its columns, then
//      warp_sum's xor butterfly, so the scores are bitwise those of the
//      one-block kernel.
//      The positives row is scanned (lanes striding it) for the candidates
//      that beat the margin, in k order, until one is not a positive: the
//      first hit.  A warp writes L*u1 and the user gradient to scratch and
//      one touch per nonzero update, the touched row or -1: touch[b] (the
//      positive item), touch[B + b] (the negative), touch[2B + b] (the user).
//   2. apply by ownership: block r owns the rows with row % G == r of both
//      tables.  It reads the step's 3B touches (12 KB at B = 1,024), keeps
//      its own as keys (side, row, position), ranks each key by the number
//      of smaller ones (the keys are distinct) to sort them, and a warp per
//      run sums the run's gradients in key order, position order as the
//      first version sums them, then applies adagrad to the row.  A block
//      can receive all 3B keys (a hot row, or G = 1), so its list holds 3B:
//      in shared memory up to kSmemKeys, else in a global slab per block.
// The tables, the gradients and the touches are written inside the launch
// by other blocks, so they are read with ld.global.cg (L2, past the SM's
// L1, which is not kept coherent across SMs).  Each row's sums are taken in
// the same order at any G, no float atomics: a fit is bitwise the same at
// every grid size, and two launches are bitwise equal.
//
// Bound on the card.  Bytes: the state read and written once, the batches,
// negatives and positives read once (0.0142 ms for the quickstart-size fit;
// its FLOP are fewer).  But the S steps form a chain, and a step cannot end
// before two grid barriers and the L2 trips on its critical path: ids ->
// rows -> positives scan -> gradient and touch stores | barrier | touches
// -> run's gradients and row -> table store | barrier.  The chain floor is
// S x (2 barriers + 7 L2 trips), from the barrier and L2 latency measured
// on the card by the two probes below (chip_smoke.py phase 7).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSumBatch = 8;   // a run's gradients loaded at once
constexpr int kSmemKeys = 6144;  // two lists of this many keys: 96 KB
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return __shfl_sync(kFull, x, 0);  // lane 0's value, on every lane
}

__device__ __forceinline__ unsigned long long touch_key(unsigned side, int row,
                                                        unsigned pos) {
  return ((unsigned long long)side << 63) |
         ((unsigned long long)(unsigned)row << 32) | pos;
}

// kCols columns a lane holds: W <= 32 * kCols.
template <int kCols>
__global__ void __launch_bounds__(kThreads, 1)
warp_fit_kernel(float* u_tab, float* u_acc, float* i_tab, float* i_acc,
                const int* __restrict__ batches,
                const int* __restrict__ negatives,
                const int* __restrict__ positives, int S, int B, int K, int W,
                int P, float n_items_m1, float lr, float max_loss, float* lu,
                float* gu, int* touch, unsigned long long* gkeys, int cap,
                int keys_in_smem) {
  // Candidate rows a warp loads at once: 16, or 8 at W > 64, where 16 rows
  // of 4 columns a lane would spill at 128 registers a thread.
  constexpr int kRows = kCols > 2 ? 8 : 16;
  extern __shared__ unsigned long long smem_keys[];
  __shared__ int n_own;
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x;
  const int block = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  unsigned long long* list =
      keys_in_smem ? smem_keys : gkeys + (size_t)block * 2 * cap;
  unsigned long long* sorted = list + cap;

  for (int s = 0; s < S; ++s) {
    const int* bt = batches + (size_t)s * 8 * B;
    const int* ng = negatives + (size_t)s * K * B;

    // ---- 1. forward: one warp per example ------------------------------
    for (int b = warp * G + block; b < B; b += kWarps * G) {
      const int uid = bt[b];
      const int iid = bt[B + b];
      const float y = __int_as_float(bt[2 * B + b]);
      const float wt = __int_as_float(bt[3 * B + b]);
      const bool valid = bt[4 * B + b] > 0;
      int my_id = lane < K ? ng[(size_t)lane * B + b] : 0;
      const float* urow = u_tab + (size_t)uid * W;
      const float* prow = i_tab + (size_t)iid * W;
      float u1[kCols], pr[kCols];
      float part = 0.0f;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int c = lane + 32 * q;
        u1[q] = 0.0f;
        pr[q] = 0.0f;
        if (c < W) {
          u1[q] = c == W - 1 ? 1.0f : __ldcg(urow + c);
          pr[q] = __ldcg(prow + c);
          part = fmaf(u1[q], pr[q], part);
        }
      }
      const float u_bias = __ldcg(urow + W - 1);
      const float pos_pred = warp_sum(part) + u_bias;

      bool found = false;
      int j_sel = 0, neg = 0;
      float rv[kRows][kCols];  // candidate rows held0 .. held0 + kRows - 1
      int held0 = -kRows;
      const int* prw = positives + (size_t)uid * P;
      for (int k0 = 0; k0 < K && !found; k0 += 32) {
        const int kn = min(32, K - k0);
        if (k0 > 0) my_id = lane < kn ? ng[(size_t)(k0 + lane) * B + b] : 0;
        unsigned pass = 0;  // candidates k0 + r that beat the margin
        for (int r0 = 0; r0 < kn; r0 += kRows) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int nk = __shfl_sync(kFull, my_id, (r0 + r) & 31);
            const float* nrow = i_tab + (size_t)nk * W;
#pragma unroll
            for (int q = 0; q < kCols; ++q) {
              const int c = lane + 32 * q;
              rv[r][q] = (r0 + r < kn && c < W) ? __ldcg(nrow + c) : 0.0f;
            }
          }
          held0 = k0 + r0;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            float np = 0.0f;
#pragma unroll
            for (int q = 0; q < kCols; ++q) {
              if (lane + 32 * q < W) np = fmaf(u1[q], rv[r][q], np);
            }
            const float npred = warp_sum(np) + u_bias;
            // uniform: npred is lane 0's sum
            if (r0 + r < kn && npred > pos_pred - 1.0f) pass |= 1u << (r0 + r);
          }
        }
        while (pass) {  // the margin's hits in k order, until one is no positive
          const int r = __ffs(pass) - 1;
          pass &= pass - 1;
          const int nk = __shfl_sync(kFull, my_id, r);
          bool hit_pos = false;
#pragma unroll 4
          for (int p = lane; p < P; p += 32) hit_pos |= prw[p] == nk;
          if (!__any_sync(kFull, hit_pos)) {
            found = true;
            j_sel = k0 + r;
            neg = nk;
            break;
          }
        }
      }
      float L = 0.0f;
      if (valid && y > 0.0f && found) {
        const float sampled = (float)(j_sel + 1);
        const float rank_w = logf(fmaxf(1.0f, floorf(n_items_m1 / sampled)));
        L = fminf(wt * rank_w, max_loss);
      }
      // Zero-loss examples add exact zeros: they take no touch at all, and
      // their gradients are never read.
      const bool on = L != 0.0f;
      if (on) {
        float nr[kCols];
        const int r = j_sel - held0;
        if (r >= 0 && r < kRows) {
#pragma unroll
          for (int rr = 0; rr < kRows; ++rr) {
            if (rr == r) {
#pragma unroll
              for (int q = 0; q < kCols; ++q) nr[q] = rv[rr][q];
            }
          }
        } else {
#pragma unroll
          for (int q = 0; q < kCols; ++q) {
            const int c = lane + 32 * q;
            nr[q] = c < W ? __ldcg(i_tab + (size_t)neg * W + c) : 0.0f;
          }
        }
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          const int c = lane + 32 * q;
          if (c < W) {
            lu[(size_t)b * W + c] = L * u1[q];
            gu[(size_t)b * W + c] = L * (c == W - 1 ? 1.0f : nr[q] - pr[q]);
          }
        }
      }
      if (lane == 0) {
        touch[b] = on ? iid : -1;
        touch[B + b] = on ? neg : -1;
        touch[2 * B + b] = on ? uid : -1;
      }
    }
    if (tid == 0) n_own = 0;
    grid.sync();

    // ---- 2. apply: this block's rows ------------------------------------
    for (int i = tid; i < 3 * B; i += kThreads) {
      const int row = __ldcg(touch + i);
      if (row >= 0 && row % G == block) {
        const unsigned user = i >= 2 * B;
        list[atomicAdd(&n_own, 1)] = touch_key(user, row, user ? i - 2 * B : i);
      }
    }
    __syncthreads();
    const int n = n_own;
    for (int i = tid; i < n; i += kThreads) {  // distinct keys: rank = # smaller
      const unsigned long long key = list[i];
      int rank = 0;
      for (int j = 0; j < n; ++j) rank += list[j] < key;
      sorted[rank] = key;
    }
    __syncthreads();

    for (int i = warp; i < n; i += kWarps) {
      const unsigned long long head = sorted[i] >> 32;
      if (i > 0 && (sorted[i - 1] >> 32) == head) continue;  // not a run start
      int stop = i + 1;
      while (stop < n && (sorted[stop] >> 32) == head) ++stop;
      const bool user = (head >> 31) != 0;
      const int row = (int)(head & 0x7fffffffu);
      float* tab = (user ? u_tab : i_tab) + (size_t)row * W;
      float* acc = (user ? u_acc : i_acc) + (size_t)row * W;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int c = lane + 32 * q;
        if (c >= W) continue;
        const float a = __ldcg(acc + c);
        const float t0 = __ldcg(tab + c);
        float g1 = 0.0f, g2 = 0.0f;
        for (int t = i; t < stop; t += kSumBatch) {
          float g[kSumBatch];
#pragma unroll
          for (int e = 0; e < kSumBatch; ++e) {
            g[e] = 0.0f;
            if (t + e < stop) {
              const unsigned pos = (unsigned)(sorted[t + e] & 0xffffffffu);
              if (user) {
                g[e] = __ldcg(gu + (size_t)pos * W + c);
              } else if (pos < (unsigned)B) {
                g[e] = -__ldcg(lu + (size_t)pos * W + c);  // the positive item
              } else {
                g[e] = __ldcg(lu + (size_t)(pos - B) * W + c);  // the negative
              }
            }
          }
#pragma unroll
          for (int e = 0; e < kSumBatch; ++e) {
            if (t + e < stop) {
              g1 += g[e];
              g2 += __fmul_rn(g[e], g[e]);
            }
          }
        }
        tab[c] = __fsub_rn(t0, __fmul_rn(__fmul_rn(lr, rsqrtf(a)), g1));
        acc[c] = a + g2;
      }
    }
    grid.sync();
  }
}

// Probes for the chain floor: n grid-wide barriers of an otherwise empty
// cooperative grid shaped as the fit's, and one thread chasing a ring of
// indices (ring[p] is the next p) for n hops.
__global__ void __launch_bounds__(kThreads, 1) sync_probe_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

__global__ void chase_probe_kernel(const int* ring, int n, int* out) {
  int p = 0;
  for (int i = 0; i < n; ++i) p = __ldcg(ring + p);
  *out = p;
}

template <int kCols>
cudaError_t launch_fit(void** args, int blocks, size_t smem, cudaStream_t s) {
  const void* fn = reinterpret_cast<const void*>(&warp_fit_kernel<kCols>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
  if (err != cudaSuccess) return err;
  // A cooperative grid must be resident all at once; refuse a larger one.
  if (blocks > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  return cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), args,
                                     smem, s);
}

}  // namespace

extern "C" {

const char* warp_fit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// A block's key lists stay in shared memory up to this many keys each.
int warp_fit_smem_key_capacity() { return kSmemKeys; }

// u_tab, u_acc: f32 [U, W]; i_tab, i_acc: f32 [I, W] (updated in place);
// batches: i32 [S, 8, B]; negatives: i32 [S, 1, K*B]; positives: i32 [U, P];
// lu, gu: f32 [B, W] scratch; touch: i32 [3B] scratch; keys: u64 [blocks, 2,
// cap] scratch, cap = 3B (unused when cap <= warp_fit_smem_key_capacity()).
// W <= 128; blocks no more than can be resident at once.  Returns a
// cudaError_t code.
int warp_fit_launch(float* u_tab, float* u_acc, float* i_tab, float* i_acc,
                    const int* batches, const int* negatives,
                    const int* positives, int S, int B, int K, int W, int P,
                    int n_items, float lr, float max_loss, float* lu, float* gu,
                    int* touch, unsigned long long* keys, int cap, int blocks,
                    void* stream) {
  if (S <= 0 || B <= 0) return 0;
  if (W <= 0 || W > 128 || K <= 0 || P < 0 || cap < 3 * B || blocks <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  int in_smem = cap <= kSmemKeys;
  const size_t smem = in_smem ? 2 * (size_t)cap * sizeof(unsigned long long) : 0;
  float n_items_m1 = (float)(n_items - 1);
  void* args[] = {&u_tab, &u_acc, &i_tab, &i_acc, &batches, &negatives,
                  &positives, &S, &B, &K, &W, &P, &n_items_m1, &lr,
                  &max_loss, &lu, &gu, &touch, &keys, &cap, &in_smem};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (W <= 32) {
    err = launch_fit<1>(args, blocks, smem, s);
  } else if (W <= 64) {
    err = launch_fit<2>(args, blocks, smem, s);
  } else {
    err = launch_fit<4>(args, blocks, smem, s);
  }
  return (int)err;
}

// The chain-floor probes (csrc note above); each returns a cudaError_t code.
int warp_fit_sync_probe(int blocks, int n, void* stream) {
  void* args[] = {&n};
  return (int)cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&sync_probe_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
}

int warp_fit_chase_probe(const int* ring, int n, int* out, void* stream) {
  chase_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(ring, n, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
