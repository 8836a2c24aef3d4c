// Farthest-point sampling on Hopper (sm_90a).
//
// Replaces the TPU kernel ev2hands_tpu/ops/pallas_ops.py:fps_pallas
// (_fps_kernel): for each batch row, npoint greedy steps; each step records
// the current farthest point, updates the running minimum distance
// min(d, |x - c|^2) (initialised to 1e10) and takes the argmax, first
// maximum winning.
//
// What bounds it on this card: neither bytes nor operations. A row's cloud
// is 24 KB and one step is ~N*9 flops, but the npoint steps form a chain of
// dependent block-wide argmax reductions, so the time is npoint times the
// latency of one step, and only B of the 132 SMs work.
//
// Design: one CTA per batch row, built to make a step short.
// - Each thread keeps its kPPT points (n = tid + j * kThreads) and their
//   running distances in registers for the whole loop; shared memory holds
//   one float4 copy of the cloud only so that a step reads its centroid with
//   one broadcast load.
// - One barrier a step. A warp reduces (distance bits, index) with two
//   redux.sync (__reduce_max_sync on the bits: non-negative floats order
//   like unsigned ints; __reduce_min_sync on the indices of the lanes that
//   hold that maximum), or with a butterfly on the 64-bit key
//   bits << 32 | ~index (kRedux = false, kept for comparison); lane 0 writes
//   the warp's winner to a slot chosen by the step's parity; after the
//   __syncthreads every warp reduces all slots itself, so every thread
//   holds the next index with no broadcast and no second barrier (the next
//   write to a slot of this parity comes after the next barrier, which
//   every warp reaches only after it has read this step's slots).
// - The output row is collected in registers (thread t keeps the index of
//   the steps i with i % kThreads == t) and stored coalesced once every
//   kThreads steps, not by one thread at every step.
// - kWork = false drops the centroid load and the distance work and keeps
//   the loop's barriers and reductions: the chain's floor, for measurement.
// - One CTA a row, so only B SMs work: a thread-block cluster of 2 or 4
//   CTAs a row (the slots written through distributed shared memory, one
//   cluster barrier a step) was measured on the H100 and lost at every N,
//   its barrier alone taking longer than this kernel's whole step
//   (PERF.md, K1's findings).
// Ties go to the lowest index, as jnp.argmax / torch.argmax do: ERPC
// resamples with replacement, so duplicate points and equal distances are
// common. Padding points (n >= N) hold distance 0 and an index above every
// real point's, so they never win.
//
// Exactness: the distance is (dx*dx + dy*dy) + dz*dz with every operation
// rounded on its own (__fmul_rn/__fadd_rn, and the file is built with
// -fmad=false), which is what the plain PyTorch version computes, so the
// indices agree exactly.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// (key, idx) of the warp's best lane: the largest key, the lowest idx
// among the lanes that hold it. Every lane gets the result.
template <bool kRedux>
__device__ __forceinline__ void warp_best(unsigned& key, unsigned& idx) {
  if constexpr (kRedux) {
    const unsigned k = __reduce_max_sync(kFull, key);
    idx = __reduce_min_sync(kFull, key == k ? idx : 0xffffffffu);
    key = k;
  } else {
    unsigned long long v = (static_cast<unsigned long long>(key) << 32) | ~idx;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(kFull, v, off);
      v = o > v ? o : v;
    }
    key = static_cast<unsigned>(v >> 32);
    idx = ~static_cast<unsigned>(v);
  }
}

template <int kThreads, int kPPT, bool kRedux, bool kWork>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
           int* __restrict__ out, int N, int npoint) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ float4 pts[];  // [N] (x, y, z, -)
  __shared__ uint2 slot[2][kWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  float* ps = reinterpret_cast<float*>(pts);
  for (int f = tid; f < 3 * N; f += kThreads) {  // coalesced over the row
    const int n = f / 3;
    ps[4 * n + (f - 3 * n)] = p[f];
  }
  __syncthreads();

  float x[kPPT], y[kPPT], z[kPPT], d[kPPT];
#pragma unroll
  for (int j = 0; j < kPPT; ++j) {
    const int n = tid + j * kThreads;
    const float4 q = n < N ? pts[n] : make_float4(0.f, 0.f, 0.f, 0.f);
    x[j] = q.x;
    y[j] = q.y;
    z[j] = q.z;
    d[j] = n < N ? 1e10f : 0.f;  // padding: distance 0 forever
  }

  // the caller gives starts in [0, N) (none: 0); the clamp keeps a bad one
  // in the row
  int far = start == nullptr ? 0 : min(max(start[b], 0), N - 1);
  int mine = 0;
  int* row = out + static_cast<size_t>(b) * npoint;
  for (int i = 0; i < npoint; ++i) {
    const int r = i & (kThreads - 1);
    if (r == tid) mine = far;
    if (r == kThreads - 1) row[i - r + tid] = mine;  // a full chunk: store it

    unsigned key, idx;
    if constexpr (kWork) {
      const float4 c = pts[far];
      float bv[kPPT];
      int bj[kPPT];
#pragma unroll
      for (int j = 0; j < kPPT; ++j) {
        const float dx = __fsub_rn(x[j], c.x);
        const float dy = __fsub_rn(y[j], c.y);
        const float dz = __fsub_rn(z[j], c.z);
        const float dd = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        d[j] = fminf(d[j], dd);
        bv[j] = d[j];
        bj[j] = j;
      }
      // the thread's best point by a tree of depth log2(kPPT): the left
      // operand holds the lower indices, so a tie keeps it
#pragma unroll
      for (int w = 1; w < kPPT; w *= 2) {
#pragma unroll
        for (int j = 0; j + w < kPPT; j += 2 * w) {
          if (bv[j + w] > bv[j]) {
            bv[j] = bv[j + w];
            bj[j] = bj[j + w];
          }
        }
      }
      key = __float_as_uint(bv[0]);  // a distance: >= 0
      idx = static_cast<unsigned>(tid + bj[0] * kThreads);
    } else {
      key = (static_cast<unsigned>(tid) * 2654435761u) ^ static_cast<unsigned>(i);
      idx = static_cast<unsigned>(tid);
    }
    warp_best<kRedux>(key, idx);
    if (lane == 0) slot[i & 1][warp] = make_uint2(key, idx);
    __syncthreads();
    const uint2 s = lane < kWarps ? slot[i & 1][lane] : make_uint2(0u, 0xffffffffu);
    key = s.x;
    idx = s.y;
    warp_best<kRedux>(key, idx);
    far = static_cast<int>(idx);
  }
  const int rem = npoint & (kThreads - 1);
  if (tid < rem) row[npoint - rem + tid] = mine;
}

template <int kThreads, int kPPT, bool kRedux, bool kWork>
int launch_one(const float* xyz, const int* start, int* out, int B, int N,
               int npoint, cudaStream_t stream) {
  auto kernel = fps_kernel<kThreads, kPPT, kRedux, kWork>;
  const size_t smem = static_cast<size_t>(N) * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B, kThreads, smem, stream>>>(xyz, start, out, N, npoint);
  return static_cast<int>(cudaGetLastError());
}

template <int kThreads, int kPPT>
int launch_variant(bool redux, bool work, const float* xyz, const int* start,
                   int* out, int B, int N, int npoint, cudaStream_t stream) {
  if (redux && work)
    return launch_one<kThreads, kPPT, true, true>(xyz, start, out, B, N, npoint, stream);
  if (work)
    return launch_one<kThreads, kPPT, false, true>(xyz, start, out, B, N, npoint, stream);
  if (redux)
    return launch_one<kThreads, kPPT, true, false>(xyz, start, out, B, N, npoint, stream);
  return launch_one<kThreads, kPPT, false, false>(xyz, start, out, B, N, npoint, stream);
}

}  // namespace

// xyz [B, N, 3] f32, start [B] i32 in [0, N) or null (every row from 0),
// out [B, npoint] i32, all contiguous on the current device.
// (threads, ppt) picks the instantiation: threads in {128, 256, 512, 1024},
// ppt (points a thread) a power of two from 1 to 32 with 4 * ppt registers
// of points inside the thread's share of the register file (ppt <= 16 at
// 512 threads, <= 8 at 1024), and threads * ppt >= N. redux: the two
// redux.sync (else the 64-bit butterfly); work = 0: the chain floor (no
// distance work, meaningless indices). Returns the CUDA error of the launch
// (0 = success; cudaErrorInvalidValue for a configuration that is not built
// or too small).
extern "C" int fps_launch(const float* xyz, const int* start, int* out, int B,
                          int N, int npoint, int threads, int ppt, int redux,
                          int work, void* stream) {
  if (threads * ppt < N || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool r = redux != 0, w = work != 0;
#define FPS_CASE(T, P)                                                      \
  if (threads == T && ppt == P)                                             \
    return launch_variant<T, P>(r, w, xyz, start, out, B, N, npoint, s);
  FPS_CASE(128, 1) FPS_CASE(128, 2) FPS_CASE(128, 4) FPS_CASE(128, 8)
  FPS_CASE(128, 16) FPS_CASE(128, 32)
  FPS_CASE(256, 1) FPS_CASE(256, 2) FPS_CASE(256, 4) FPS_CASE(256, 8)
  FPS_CASE(256, 16) FPS_CASE(256, 32)
  FPS_CASE(512, 1) FPS_CASE(512, 2) FPS_CASE(512, 4) FPS_CASE(512, 8)
  FPS_CASE(512, 16)
  FPS_CASE(1024, 1) FPS_CASE(1024, 2) FPS_CASE(1024, 4) FPS_CASE(1024, 8)
#undef FPS_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
