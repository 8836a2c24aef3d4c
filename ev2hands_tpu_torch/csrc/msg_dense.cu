// Block-sparse multi-scale grouping on Hopper (sm_90a): one MSG scale, or
// all scales of a layer in one launch, pooled over the points that each
// centroid selects, with the selection given as a mask over Morton-ordered
// points and a tile-activity map.
//
// Replaces two TPU kernels of ev2hands_tpu/ops/pallas_grouping.py:
// dense_msg_fused_scales_pallas_sparse (_kernel_2d_sparse_fused) and, with
// R = 1, dense_msg_scale_pallas_sparse (_kernel_2d_sparse). The other four
// grouping kernels there, which select in the kernel from a ball
// (fused_msg_scale_pallas, dense_msg_scale_pallas) or take a mask in
// original point order (dense_msg_scale_pallas_2d,
// dense_msg_scale_pallas_2d_batched), live in csrc/msg_ball.cu, its ball
// and mask modes. msg_sparse_kernel takes R scales stacked by
// stack_folded_scales (u [B, N, C1t] and v [B, S, C1t] concatenate the
// scales' first layers, W2 [C1t, C2t] and W3 [C2t, C3t] are
// block-diagonal), each scale's mask sel [B, R, S, N] over Morton-ordered
// points and the union of their tile activities act [B, S, N / nb]. For
// each (b, s) and scale r of the output's sections it pools
//   out[b, s, c] = max over the selected points n of
//                  relu(relu(relu(u[b, n] - v[b, s]) @ W2 + b2) @ W3 + b3)[c]
// over u [B, N, C1], v [B, S, C1], W2 [C1, C2], W3 [C2, C3], and leaves
// -1e30 where the mask selects nothing, as the TPU kernels do (their masked
// rows contribute h - 1e30 == -1e30 in f32). It reads a scale's mask only on
// union-active tiles and runs the scale's own chain (its diagonal blocks):
// the off-diagonal zeros would add exact +0.0 terms, and a row that scale r
// does not select never reaches section r, so the values are the same with
// no wasted work.
//
// What bounds it on this card: the work is 2 * (C1 * C2 + C2 * C3) flops for
// each selected pair; the bytes are u, v, the weights, the output and R mask
// slices of nb floats for each union-active tile. At sa1's and the regressor
// heads' shapes the f32 operations bound it, except the narrowest sa1 scale
// on its own, which its bytes bound.
//
// Design (simple first; no tensor cores or TMA). The TPU kernels ran the
// chain over all N points of a centroid and masked the max. Here a CTA of
// 256 threads takes kCentroids centroids of one scale, one after another:
// it compacts the points that the scale's mask row selects on the
// union-active tiles into a shared list, then runs one chain (pool_rows)
// over the list only, 32 rows at a time, so it does the selected pairs'
// work and no more. Widths up to C1 = 128, C2 = 256, C3 = 256 in any
// combination (TEHNet's widest MSG scale is (128, 196, 256)): their weights
// (up to 384 KB in f32; sa1's stacked ones 368 KB) do not fit in shared
// memory, so they are read through the L1/L2 caches, and each thread
// carries 8 rows of one output column through a layer so that a weight it
// reads serves 8 rows. The tiles of the chain lie transposed in shared
// memory ([channel][row]) so those 8 rows come as two float4 loads. Each
// output accumulates in f32 FMAs over the input channels ascending from
// 0.0f. The max over rows folds into shared memory with an integer
// atomicMax on the float bits, exact because every value is a relu output
// (>= +0.0) or the -1e30 it starts from. The grid is (centroid block, b,
// scale), widest scale first; each CTA's shared memory is its two tiles,
// v, the running max and the list, so several fit on an SM.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;        // selected rows in the chain at a time
constexpr int kLd = kRows + 4;   // row stride of the transposed tiles
constexpr int kRB = 8;           // rows a thread carries through a layer
constexpr int kMaxC1 = 128;
constexpr int kMaxC2 = 256;
constexpr int kMaxC3 = 256;
constexpr int kMaxScales = 3;    // the scales of TEHNet's MSG layers
// Centroids per CTA of the sparse kernel. A sweep of 1, 2, 4 and 8 picked 2;
// its times were not kept, so the choice is unmeasured.
constexpr int kCentroids = 2;

bool widths_ok(int c1, int c2, int c3) {
  return c1 > 0 && c1 <= kMaxC1 && c2 > 0 && c2 <= kMaxC2 && c3 > 0 && c3 <= kMaxC3;
}

struct Shared {
  float* zT;    // [c1][kLd]  relu(u - v) of the rows in the chain
  float* hT;    // [c2][kLd]  the second layer's output
  float* v;     // [c1]       this centroid's v
  int* mx;      // [c3]       running max, float bits
  int* rows;    // the selected point indices
};

__device__ Shared carve(float* smem, int c1, int c2, int c3) {
  Shared sh;
  sh.zT = smem;
  sh.hT = sh.zT + kLd * c1;
  sh.v = sh.hT + kLd * c2;
  sh.mx = reinterpret_cast<int*>(sh.v + c1);
  sh.rows = sh.mx + c3;
  return sh;
}

// Loads v[b, s] and sets the running max to -1e30. The caller syncs.
__device__ void start_centroid(const Shared& sh, const float* __restrict__ v_bs,
                               int c1, int c3) {
  for (int c = threadIdx.x; c < c1; c += kThreads) sh.v[c] = v_bs[c];
  for (int c = threadIdx.x; c < c3; c += kThreads) sh.mx[c] = __float_as_int(-1e30f);
}

// One layer over the transposed input tile inT [cin][kLd] of nrb row
// blocks, with weights W [cin, cout] of row stride ldw: item (rb, col)
// computes rows rb * kRB .. + kRB - 1 of output column col, each as a
// sequential f32 FMA sum over cin, plus the bias, through relu. With `out` it writes them to out [cout][kLd]; otherwise it
// folds the largest of its rows below rn into the running max.
__device__ void layer(const float* inT, int cin, const float* __restrict__ W, int ldw,
                      const float* __restrict__ bias, int cout, int nrb, int rn,
                      float* out, int* mx) {
  for (int e = threadIdx.x; e < nrb * cout; e += kThreads) {
    const int rb = e / cout, col = e - rb * cout;
    const float* x = inT + rb * kRB;
    float acc[kRB];
#pragma unroll
    for (int j = 0; j < kRB; ++j) acc[j] = 0.0f;
    for (int k = 0; k < cin; ++k) {
      const float w = __ldg(W + static_cast<size_t>(k) * ldw + col);
      const float4 x0 = *reinterpret_cast<const float4*>(x + k * kLd);
      const float4 x1 = *reinterpret_cast<const float4*>(x + k * kLd + 4);
      acc[0] = fmaf(x0.x, w, acc[0]);
      acc[1] = fmaf(x0.y, w, acc[1]);
      acc[2] = fmaf(x0.z, w, acc[2]);
      acc[3] = fmaf(x0.w, w, acc[3]);
      acc[4] = fmaf(x1.x, w, acc[4]);
      acc[5] = fmaf(x1.y, w, acc[5]);
      acc[6] = fmaf(x1.z, w, acc[6]);
      acc[7] = fmaf(x1.w, w, acc[7]);
    }
    const float b = __ldg(bias + col);
#pragma unroll
    for (int j = 0; j < kRB; ++j) {
      const float y = acc[j] + b;
      acc[j] = y > 0.0f ? y : 0.0f;   // +0.0 for y <= 0: the max's int order
    }
    if (out != nullptr) {
      float4* o = reinterpret_cast<float4*>(out + col * kLd + rb * kRB);
      o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    } else {
      float m = acc[0];   // row rb * kRB < rn for every block below nrb
#pragma unroll
      for (int j = 1; j < kRB; ++j) {
        if (rb * kRB + j < rn) m = fmaxf(m, acc[j]);
      }
      atomicMax(mx + col, __float_as_int(m));
    }
  }
}

// The chain of one scale: weights W2 [c1, c2] and W3 [c2, c3] of row
// strides ld2 and ld3 (the diagonal blocks of stacked weights, or whole
// ones), their biases, and the row stride ldu of its per-point half u.
struct Chain {
  const float* W2;
  const float* b2;
  const float* W3;
  const float* b3;
  int c1, c2, c3, ldu, ld2, ld3;
};

// Runs the chain over the rows sh.rows[0 .. nsel) of u_b [N, ldu] (columns
// 0 .. c1) and folds them into the running max, which it writes to out_bs
// [c3]. Called by the whole CTA after a sync that publishes sh.v, sh.mx and
// the rows.
__device__ void pool_rows(const Shared& sh, int nsel, const float* __restrict__ u_b,
                          const Chain& ch, float* __restrict__ out_bs) {
  const int c1 = ch.c1, c2 = ch.c2, c3 = ch.c3;
  for (int r0 = 0; r0 < nsel; r0 += kRows) {
    const int rn = min(kRows, nsel - r0);
    const int nrb = (rn + kRB - 1) / kRB;
    // z = relu(u - v), transposed; the padding rows of the last block are 0
    for (int e = threadIdx.x; e < nrb * kRB * c1; e += kThreads) {
      const int i = e / c1, k = e - i * c1;
      sh.zT[k * kLd + i] =
          i < rn ? fmaxf(u_b[static_cast<size_t>(sh.rows[r0 + i]) * ch.ldu + k] - sh.v[k], 0.0f)
                 : 0.0f;
    }
    __syncthreads();
    layer(sh.zT, c1, ch.W2, ch.ld2, ch.b2, c2, nrb, rn, sh.hT, nullptr);
    __syncthreads();
    layer(sh.hT, c2, ch.W3, ch.ld3, ch.b3, c3, nrb, rn, nullptr, sh.mx);
    __syncthreads();   // zT and hT are rewritten by the next pass
  }
  for (int c = threadIdx.x; c < c3; c += kThreads) out_bs[c] = __int_as_float(sh.mx[c]);
}

// The per-scale blocks of the sparse kernel's stacked operands: scale r's
// widths and its offsets into the stacked channels C1t, C2t, C3t.
struct Blocks {
  int R;
  int c1[kMaxScales], c2[kMaxScales], c3[kMaxScales];
  int o1[kMaxScales], o2[kMaxScales], o3[kMaxScales];
  int C1t, C2t, C3t;
  int c12, c13;   // the largest c1 + c2 and c1 + c3 over the scales
};

// Fills the block table from the per-scale widths [R, 3]; false when they do
// not fit the kernel.
bool make_blocks(int R, const int* widths, Blocks* bk) {
  if (R < 1 || R > kMaxScales) return false;
  *bk = Blocks{};
  bk->R = R;
  for (int r = 0; r < R; ++r) {
    const int c1 = widths[3 * r], c2 = widths[3 * r + 1], c3 = widths[3 * r + 2];
    if (!widths_ok(c1, c2, c3)) return false;
    bk->c1[r] = c1;
    bk->c2[r] = c2;
    bk->c3[r] = c3;
    bk->o1[r] = bk->C1t;
    bk->o2[r] = bk->C2t;
    bk->o3[r] = bk->C3t;
    bk->C1t += c1;
    bk->C2t += c2;
    bk->C3t += c3;
    bk->c12 = c1 + c2 > bk->c12 ? c1 + c2 : bk->c12;
    bk->c13 = c1 + c3 > bk->c13 ? c1 + c3 : bk->c13;
  }
  return true;
}

// Dynamic shared memory of a sparse launch: the largest scale's tiles, v and
// running max, and a list of N point indices.
size_t sparse_smem_bytes(const Blocks& bk, int N) {
  return (static_cast<size_t>(kLd) * bk.c12 + bk.c13 + N) * 4;
}

// Block-sparse grouping (K2 with R = 1, K3): CTA (centroid block, b, scale)
// runs its scale's diagonal blocks over the points that the scale's mask
// selects inside the union-active tiles, for kCentroids centroids.
__global__ void __launch_bounds__(kThreads)
msg_sparse_kernel(const float* __restrict__ u, const float* __restrict__ v,
                  const float* __restrict__ sel, const int* __restrict__ act,
                  const float* __restrict__ W2, const float* __restrict__ b2,
                  const float* __restrict__ W3, const float* __restrict__ b3,
                  float* __restrict__ out, const Blocks bk, int S, int N, int nb) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int nrows;
  // the last scale first: layers list their radii from small to large, and
  // the widest ball's CTAs are the longest, so the short ones fill the tail
  const int r = bk.R - 1 - blockIdx.z;
  const int o1 = bk.o1[r], o2 = bk.o2[r], o3 = bk.o3[r];
  const Chain ch{W2 + static_cast<size_t>(o1) * bk.C2t + o2, b2 + o2,
                 W3 + static_cast<size_t>(o2) * bk.C3t + o3, b3 + o3,
                 bk.c1[r], bk.c2[r], bk.c3[r], bk.C1t, bk.C2t, bk.C3t};
  const Shared sh = carve(smem, ch.c1, ch.c2, ch.c3);
  const int b = blockIdx.y;
  const int nt = N / nb;
  const float* u_b = u + static_cast<size_t>(b) * N * bk.C1t + o1;
  const int s_end = min(S, (blockIdx.x + 1) * kCentroids);
  for (int s = blockIdx.x * kCentroids; s < s_end; ++s) {
    const size_t bs = static_cast<size_t>(b) * S + s;
    __syncthreads();   // the previous centroid is done with sh and nrows
    if (threadIdx.x == 0) nrows = 0;
    start_centroid(sh, v + bs * bk.C1t + o1, ch.c1, ch.c3);
    __syncthreads();
    // this scale's selected points of the union-active tiles
    const float* sel_row = sel + ((static_cast<size_t>(b) * bk.R + r) * S + s) * N;
    const int* act_row = act + bs * nt;
    for (int ti = 0; ti < nt; ++ti) {
      if (act_row[ti] == 0) continue;   // the same for every thread
      for (int n = ti * nb + threadIdx.x; n < (ti + 1) * nb; n += kThreads) {
        if (sel_row[n] > 0.5f) sh.rows[atomicAdd(&nrows, 1)] = n;
      }
    }
    __syncthreads();
    pool_rows(sh, nrows, u_b, ch, out + bs * bk.C3t + o3);
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// Dynamic shared memory the sparse kernel needs, in bytes, for R scales
// whose (C1, C2, C3) widths are widths[3 r .. 3 r + 2], at N points; 0 when
// they do not fit the kernel.
extern "C" size_t msg_sparse_smem_bytes(int N, int R, const int* widths) {
  Blocks bk;
  if (!make_blocks(R, widths, &bk) || N < 1) return 0;
  return sparse_smem_bytes(bk, N);
}

// u [B, N, C1t], v [B, S, C1t], sel [B, R, S, N] f32 (0/1), act [B, S, N/nb]
// i32, W2 [C1t, C2t], b2 [C2t], W3 [C2t, C3t], b3 [C3t], out [B, S, C3t] f32;
// all contiguous on the current device. widths: R rows of (C1, C2, C3) on
// the host, summing to C1t, C2t, C3t. Returns the CUDA error of the launch
// (0 = success).
extern "C" int msg_sparse_launch(const float* u, const float* v, const float* sel,
                                 const int* act, const float* W2, const float* b2,
                                 const float* W3, const float* b3, float* out,
                                 const int* widths, int B, int S, int N, int R, int nb,
                                 int C1t, void* stream) {
  Blocks bk;
  if (!make_blocks(R, widths, &bk) || bk.C1t != C1t || B < 1 || S < 1 || nb <= 0 ||
      N < 1 || N % nb != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sparse_smem_bytes(bk, N);
  cudaError_t err = prepare(msg_sparse_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kCentroids - 1) / kCentroids, B, R);
  msg_sparse_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      u, v, sel, act, W2, b2, W3, b3, out, bk, S, N, nb);
  return static_cast<int>(cudaGetLastError());
}
