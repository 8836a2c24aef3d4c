// Block-sparse multi-scale grouping on Hopper (sm_90a): all R scales of one
// set-abstraction layer in one launch, or one scale with R = 1.
//
// Replaces two TPU kernels of ev2hands_tpu/ops/pallas_grouping.py:
// dense_msg_fused_scales_pallas_sparse (_kernel_2d_sparse_fused), and with
// R = 1 dense_msg_scale_pallas_sparse (_kernel_2d_sparse). Its inputs are
// the R scales stacked by stack_folded_scales: u [B, N, C1t] and
// v [B, S, C1t] concatenate the scales' first layers, W2 [C1t, C2t] and
// W3 [C2t, C3t] are block-diagonal, sel [B, R, S, N] holds each scale's
// selection mask and act [B, S, N / nb] the union of the scales' tile
// activities. For each (b, s) and each column c of scale r's output section
// it pools
//   out[b, s, c] = max over the points n that scale r selects, inside
//                  union-active tiles, of
//                  relu(relu(relu(u[b, n] - v[b, s]) @ W2 + b2) @ W3 + b3)[c]
// and leaves -1e30 where scale r selects nothing, as the TPU kernels do
// (their masked rows contribute h - 1e30 == -1e30 in f32). Points (u rows,
// sel columns) come in Morton order; the max does not depend on the order.
// The off-diagonal blocks of W2 and W3 are zeros that add exact +0.0 terms,
// and a row that scale r does not select never reaches section r, so the
// kernel runs each scale's own chain (its diagonal blocks) over the rows
// that scale selects: the same values with no wasted work.
//
// What bounds it on this card: the work is 2 * (C1r * C2r + C2r * C3r)
// flops for each pair that scale r selects; the bytes are R mask slices of
// nb floats for each union-active tile, u, v, the diagonal weight blocks,
// act and the output. At the main path's shapes (TEHNet's sa1 on uniform
// events) the f32 operations bound it, except the narrowest scale on its
// own, which its bytes bound.
//
// Design (simple first; no tensor cores or TMA yet). On the TPU one grid
// step ran every scale of a tile to save matrix-unit issues; here the rows
// are compacted, so the union saves no work, and what the fused launch
// keeps is one launch for the layer. The stacked sa1 weights are 368 KB in
// f32, more than a CTA's 227 KB of shared memory, and even their diagonal
// blocks (135 KB) would leave room for one CTA per SM. So the grid's third
// axis is the scale: a CTA of 256 threads stages only its scale's diagonal
// blocks (at most 72 KB at sa1, found from the per-scale (C1, C2, C3)
// widths the wrapper passes, never inferred from zeros) and serves 8
// centroids of one batch row. Per centroid it reads its scale's mask on the
// union-active tiles only, compacts the selected point indices into a
// shared list, runs the chain over the list 32 rows at a time in shared
// memory and keeps a running max per output channel in registers, one
// thread per channel (C3r <= 256). Everything accumulates in f32.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;        // rows of the chain held in shared memory
constexpr int kCentroids = 8;    // centroids per CTA
constexpr int kMaxScales = 3;    // the scales of TEHNet's MSG layers

struct Blocks {
  int R;
  int c1[kMaxScales], c2[kMaxScales], c3[kMaxScales];
  int o1[kMaxScales], o2[kMaxScales], o3[kMaxScales];  // offsets in C1t, C2t, C3t
  int C1t, C2t, C3t;
  int smem_floats;   // the largest scale's share of shared memory, in floats
};

// Floats of shared memory for one scale of these widths (the list of
// selected points comes on top).
int scale_floats(int c1, int c2, int c3) {
  return c1 * c2 + c2 * c3 + c2 + c3 + c1 + kRows * (c1 + c2) + kThreads;
}

// Fills the block table from the per-scale widths [R, 3]; false when they do
// not fit the kernel.
bool make_blocks(int R, const int* widths, Blocks* bk) {
  if (R < 1 || R > kMaxScales) return false;
  *bk = Blocks{};
  bk->R = R;
  for (int r = 0; r < R; ++r) {
    const int c1 = widths[3 * r], c2 = widths[3 * r + 1], c3 = widths[3 * r + 2];
    if (c1 <= 0 || c2 <= 0 || c3 <= 0 || c3 > kThreads) return false;
    bk->c1[r] = c1;
    bk->c2[r] = c2;
    bk->c3[r] = c3;
    bk->o1[r] = bk->C1t;
    bk->o2[r] = bk->C2t;
    bk->o3[r] = bk->C3t;
    bk->C1t += c1;
    bk->C2t += c2;
    bk->C3t += c3;
    const int f = scale_floats(c1, c2, c3);
    bk->smem_floats = f > bk->smem_floats ? f : bk->smem_floats;
  }
  return true;
}

__global__ void __launch_bounds__(kThreads)
msg_sparse_fused_kernel(const float* __restrict__ u, const float* __restrict__ v,
                        const float* __restrict__ sel, const int* __restrict__ act,
                        const float* __restrict__ W2, const float* __restrict__ b2,
                        const float* __restrict__ W3, const float* __restrict__ b3,
                        float* __restrict__ out, const Blocks bk, int S, int N,
                        int nb) {
  extern __shared__ float smem[];
  // the last scale first: layers list their radii from small to large, and
  // the widest ball's CTAs are the longest, so the short ones fill the tail
  const int r = bk.R - 1 - blockIdx.z;
  const int c1 = bk.c1[r], c2 = bk.c2[r], c3 = bk.c3[r];
  const int o1 = bk.o1[r], o2 = bk.o2[r], o3 = bk.o3[r];
  const int C1t = bk.C1t, C2t = bk.C2t, C3t = bk.C3t;
  float* sW2 = smem;                 // [c1, c2] scale r's diagonal block of W2
  float* sW3 = sW2 + c1 * c2;        // [c2, c3] its block of W3
  float* sb2 = sW3 + c2 * c3;        // [c2]
  float* sb3 = sb2 + c2;             // [c3]
  float* sv = sb3 + c3;              // [c1]    this centroid's v
  float* sz = sv + c1;               // [kRows, c1]
  float* sh = sz + kRows * c1;       // [kRows, c2]
  float* sred = sh + kRows * c2;     // [kThreads] partial maxima
  int* rows = reinterpret_cast<int*>(smem + bk.smem_floats);  // [N] selected points
  __shared__ int nrows;

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int nt = N / nb;
  for (int e = tid; e < c1 * c2; e += kThreads) {
    const int i = e / c2, j = e - i * c2;
    sW2[e] = W2[static_cast<size_t>(o1 + i) * C2t + o2 + j];
  }
  for (int e = tid; e < c2 * c3; e += kThreads) {
    const int i = e / c3, j = e - i * c3;
    sW3[e] = W3[static_cast<size_t>(o2 + i) * C3t + o3 + j];
  }
  for (int e = tid; e < c2; e += kThreads) sb2[e] = b2[o2 + e];
  for (int e = tid; e < c3; e += kThreads) sb3[e] = b3[o3 + e];

  // last layer: thread (grp, col) owns output channel col of the section
  // for rows grp, grp + G, ...; threads past G * c3 idle there
  const int G = kThreads / c3;
  const int grp = tid / c3;
  const int col = tid - grp * c3;
  const float* u_b = u + static_cast<size_t>(b) * N * C1t + o1;

  const int s_end = min(S, (blockIdx.x + 1) * kCentroids);
  for (int s = blockIdx.x * kCentroids; s < s_end; ++s) {
    const size_t bs = static_cast<size_t>(b) * S + s;
    __syncthreads();  // the previous centroid is done with sv, rows, sred
    if (tid == 0) nrows = 0;
    for (int c = tid; c < c1; c += kThreads) sv[c] = v[bs * C1t + o1 + c];
    __syncthreads();

    // this scale's selected points of the union-active tiles
    const float* sel_row = sel + ((static_cast<size_t>(b) * bk.R + r) * S + s) * N;
    const int* act_row = act + bs * nt;
    for (int ti = 0; ti < nt; ++ti) {
      if (act_row[ti] == 0) continue;  // the same for every thread
      for (int n = ti * nb + tid; n < (ti + 1) * nb; n += kThreads) {
        if (sel_row[n] > 0.5f) rows[atomicAdd(&nrows, 1)] = n;
      }
    }
    __syncthreads();
    const int nsel = nrows;

    float m = -1e30f;
    for (int r0 = 0; r0 < nsel; r0 += kRows) {
      const int rn = min(kRows, nsel - r0);
      for (int e = tid; e < rn * c1; e += kThreads) {
        const int i = e / c1, c = e - i * c1;
        sz[e] = fmaxf(u_b[static_cast<size_t>(rows[r0 + i]) * C1t + c] - sv[c], 0.0f);
      }
      __syncthreads();
      for (int e = tid; e < rn * c2; e += kThreads) {
        const int i = e / c2, c = e - i * c2;
        const float* zr = sz + i * c1;
        float acc = 0.0f;
        for (int k = 0; k < c1; ++k) acc = fmaf(zr[k], sW2[k * c2 + c], acc);
        sh[e] = fmaxf(acc + sb2[c], 0.0f);
      }
      __syncthreads();
      if (grp < G) {
        for (int i = grp; i < rn; i += G) {
          const float* hr = sh + i * c2;
          float acc = 0.0f;
          for (int k = 0; k < c2; ++k) acc = fmaf(hr[k], sW3[k * c3 + col], acc);
          m = fmaxf(m, fmaxf(acc + sb3[col], 0.0f));
        }
      }
      __syncthreads();  // sz and sh are rewritten by the next pass
    }

    sred[tid] = m;
    __syncthreads();
    if (tid < c3) {
      float mm = sred[tid];
      for (int g = 1; g < G; ++g) mm = fmaxf(mm, sred[g * c3 + tid]);
      out[bs * C3t + o3 + tid] = mm;
    }
  }
}

}  // namespace

// Dynamic shared memory the kernel needs, in bytes, for R scales whose
// (C1, C2, C3) widths are widths[3 r .. 3 r + 2]; 0 when they do not fit.
extern "C" size_t msg_sparse_fused_smem_bytes(int N, int R, const int* widths) {
  Blocks bk;
  if (!make_blocks(R, widths, &bk)) return 0;
  return (static_cast<size_t>(bk.smem_floats) + N) * 4;
}

// u [B, N, C1t], v [B, S, C1t], sel [B, R, S, N] f32 (0/1), act [B, S, N/nb]
// i32, W2 [C1t, C2t], b2 [C2t], W3 [C2t, C3t], b3 [C3t], out [B, S, C3t] f32;
// all contiguous on the current device. widths: R rows of (C1, C2, C3) on
// the host, summing to C1t, C2t, C3t. Returns the CUDA error of the launch
// (0 = success).
extern "C" int msg_sparse_fused_launch(const float* u, const float* v,
                                       const float* sel, const int* act,
                                       const float* W2, const float* b2,
                                       const float* W3, const float* b3, float* out,
                                       const int* widths, int B, int S, int N, int R,
                                       int nb, int C1t, void* stream) {
  Blocks bk;
  if (!make_blocks(R, widths, &bk) || bk.C1t != C1t || nb <= 0 || N % nb != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = (static_cast<size_t>(bk.smem_floats) + N) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      msg_sparse_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kCentroids - 1) / kCentroids, B, R);
  msg_sparse_fused_kernel<<<grid, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      u, v, sel, act, W2, b2, W3, b3, out, bk, S, N, nb);
  return static_cast<int>(cudaGetLastError());
}
