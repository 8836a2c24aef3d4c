// Grouped-neighbor gather and its scatter-add backward on Hopper (sm_90a).
//
// Replaces the TPU kernels of ev2hands_tpu/ops/pallas_gather.py:
//   * _onehot_gather (_kernel): the rows of a source [B, N, C] at [B, S, K]
//     positions -> [B, S, K, C]. The TPU made this exact gather a one-hot
//     product on its bf16 matrix unit, the f32 values split into three bf16
//     terms; here a row is copied, which is exact by construction.
//   * _onehot_scatter_add (_scatter_kernel): the gather's VJP, for each
//     source row the sum of the cotangents of the slots that hold it,
//     [B, S, K, C] -> [B, N, C].
//
// What bounds them on this card: bytes. Neither does arithmetic beyond the
// scatter's one add per element. The gather reads the K rows of a centroid
// (C floats each) and writes S*K*C floats per batch row; the scatter reads
// the S*K*C cotangents and adds them into an [N, C] block that stays in the
// 50 MB L2 (at most 8*512*323 floats, 5.3 MB).
//
// Design (simple first): one CTA per (b, s). It stages the centroid's K
// positions in shared memory, then its threads walk the K*C output (or
// cotangent) elements in order, so neighbouring threads touch neighbouring
// addresses of the [K, C] slab and of each source row. Rows of C = 323
// floats (1292 B) are not 16-byte aligned, so every access is a scalar
// 4-byte one. The TPU kernels' tile-activity map is not read: a CTA visits
// only its K slots. A position outside [0, N) matches no row: the gather
// writes zeros there and the scatter drops it, as the one-hot product does.
//
// The scatter adds with f32 atomics, so the order of the sums of a row
// changes from run to run (as the TPU kernel's differs from XLA's scatter
// "up to summation order"). Its launch zeroes the output first.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 1024;  // slots per centroid staged in shared memory

__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ src, const int* __restrict__ idx,
              float* __restrict__ out, int N, int S, int K, int C) {
  __shared__ int pos[kMaxK];
  const int row = blockIdx.x;  // b * S + s
  const int b = row / S;
  const int* row_idx = idx + static_cast<size_t>(row) * K;
  for (int k = threadIdx.x; k < K; k += kThreads) pos[k] = row_idx[k];
  __syncthreads();

  const float* src_b = src + static_cast<size_t>(b) * N * C;
  float* out_row = out + static_cast<size_t>(row) * K * C;
  const int total = K * C;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int k = e / C;
    const int c = e - k * C;
    const int p = pos[k];
    out_row[e] = (p >= 0 && p < N) ? src_b[static_cast<size_t>(p) * C + c] : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                   float* __restrict__ out, int N, int S, int K, int C) {
  __shared__ int pos[kMaxK];
  const int row = blockIdx.x;  // b * S + s
  const int b = row / S;
  const int* row_idx = idx + static_cast<size_t>(row) * K;
  for (int k = threadIdx.x; k < K; k += kThreads) pos[k] = row_idx[k];
  __syncthreads();

  float* out_b = out + static_cast<size_t>(b) * N * C;
  const float* g_row = g + static_cast<size_t>(row) * K * C;
  const int total = K * C;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int k = e / C;
    const int c = e - k * C;
    const int p = pos[k];
    if (p >= 0 && p < N) atomicAdd(out_b + static_cast<size_t>(p) * C + c, g_row[e]);
  }
}

bool bad_shape(int B, int N, int S, int K, int C) {
  return B <= 0 || N <= 0 || S <= 0 || K <= 0 || K > kMaxK || C <= 0 ||
         static_cast<long long>(B) * S > 0x7fffffffLL ||
         static_cast<long long>(K) * C > 0x7fffffffLL;
}

}  // namespace

// src [B, N, C] f32, idx [B, S, K] i32, out [B, S, K, C] f32, contiguous on
// the current device. Returns the CUDA error of the launch (0 = success).
extern "C" int onehot_gather_launch(const float* src, const int* idx, float* out,
                                    int B, int N, int S, int K, int C,
                                    void* stream) {
  if (bad_shape(B, N, S, K, C)) return static_cast<int>(cudaErrorInvalidValue);
  gather_kernel<<<B * S, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, idx, out, N, S, K, C);
  return static_cast<int>(cudaGetLastError());
}

// g [B, S, K, C] f32, idx [B, S, K] i32, out [B, N, C] f32 (overwritten),
// contiguous on the current device. Returns the CUDA error (0 = success).
extern "C" int onehot_scatter_add_launch(const float* g, const int* idx, float* out,
                                         int B, int N, int S, int K, int C,
                                         void* stream) {
  if (bad_shape(B, N, S, K, C)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(B) * N * C * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_add_kernel<<<B * S, kThreads, 0, st>>>(g, idx, out, N, S, K, C);
  return static_cast<int>(cudaGetLastError());
}
