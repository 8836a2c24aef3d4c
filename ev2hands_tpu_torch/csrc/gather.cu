// Grouped-neighbor gather and its scatter-add backward on Hopper (sm_90a).
//
// Replaces the TPU kernels of ev2hands_tpu/ops/pallas_gather.py:
//   * _onehot_gather (_kernel): the rows of a source [B, N, C] at [B, S, K]
//     positions -> [B, S, K, C]. The TPU made this exact gather a one-hot
//     product on its bf16 matrix unit, the f32 values split into three bf16
//     terms; here a value is copied, which is exact by construction.
//   * _onehot_scatter_add (_scatter_kernel): the gather's VJP, for each
//     source row the sum of the cotangents of the slots that hold it,
//     [B, S, K, C] -> [B, N, C].
//
// What bounds them on this card: bytes. Neither does arithmetic beyond the
// scatter's one add per element. The gather writes B*S*K*C floats and reads
// the source rows it copies (at most 8*512*323 floats, 5.3 MB, which stay
// in the 50 MB L2); the scatter reads the B*S*K*C cotangents once and
// writes [B, N, C] once.
//
// Gather design: the output is one contiguous array, and each thread of a
// grid sized from the SM count strides over it in 16-byte chunks of four
// floats. It finds a chunk's first slot, channel and batch row with two
// divisions by multiply-and-shift and steps through the rest, so a chunk
// that crosses into the next slot (C not a multiple of 4) needs no more. It
// reads the source through L1/L2 with scalar loads (rows of C = 7 or 323
// floats are not 16-byte aligned) and stores the chunk as one float4; the
// last B*S*K*C % 4 floats, or every float where the output is not 16-byte
// aligned, are stored one by one. Nothing is staged and nothing syncs, so a
// narrow source (C = 7, 8) keeps as many chunks in flight as a wide one
// (C = 323). Positions are the ball query's int64, read as they are.
//
// Scatter design (destination-major, deterministic): each output element
// is the sum of its slots' cotangents in an order fixed by the inputs, so
// two launches on the same inputs give the same bits. No atomic touches a
// value; integer atomics only count. Five passes over a batch row's S*K
// slots, cut into tiles of kTile:
//   1. one CTA per (tile, batch row) counts the tile's slots of each
//      destination row in shared memory (the final counts do not depend on
//      the atomics' order; a warp's slots of one row make one atomic);
//   2. one CTA per batch row scans them: each row's start and length in a
//      slot list, each tile's offset within each row, and the row's
//      segments of at most kSeg slots;
//   3. one CTA per (tile, batch row) sorts its slots by row with a stable
//      block radix sort (CUB's BlockRadixSort, a building block inside this
//      kernel) and writes each slot id at its row's start + the row's slots
//      of earlier tiles + its rank within the row's run: a stable counting
//      sort over the tiles, so each row's list is in ascending slot order
//      s * K + k;
//   4. one warp per (segment, group of 8, 16 or 32 channels) sums its
//      segment's cotangents; where the group is narrower than the warp
//      (C <= 16) its 32 / W streams each sum every (32 / W)-th slot in
//      order and their sums are added in stream order;
//   5. one warp per (row, 32 channels) adds the row's segment sums in order
//      and writes the output row once.
// The order depends only on the slots' rows. Segments and streams are there
// because the ball query's backfill puts a ball's first point in every slot
// it cannot fill: at the training step's shapes a row holds 17-56 slots on
// average and up to ~1,500, and one warp walking such a row alone would set
// the kernel's time.
// Design (b), the TPU kernel's walk over a tile's active centroids, would
// serialise a tile's centroids in one CTA; the destination-major lists give
// every row its own warps, and read the [B, S, K, C] cotangents once.
// A position outside [0, N) matches no row: the gather writes zeros there
// and the scatter drops it, as the one-hot product does.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kTile = 2048;                  // scatter: slots of a batch row per tile
constexpr int kSeg = 256;                    // scatter: slots of a row a warp sums
constexpr int kRowsPerCta = kThreads / 32;   // scatter passes 4, 5: a warp an item
constexpr unsigned kFull = 0xffffffffu;
// Destination rows a batch row may have: the scatter keeps a count per row
// in shared memory (227 KB).
constexpr int kMaxN = 56 * 1024;

// Division of 0 <= n < 2^31 by a fixed d >= 1 as a multiply and a shift:
// m = floor(2^(32 + l) / d) + 1 with 2^l >= d makes floor(n * m / 2^(32 + l))
// exact, since the error n * (m - 2^(32 + l) / d) / 2^(32 + l) < 1 / (2 d).
struct Div {
  unsigned long long m;
  int s;
};

Div make_div(int d) {
  int l = 0;
  while ((1LL << l) < d) ++l;
  return Div{(1ULL << (32 + l)) / static_cast<unsigned long long>(d) + 1, 32 + l};
}

__device__ __forceinline__ int divide(int n, const Div& d) {
  return static_cast<int>((static_cast<unsigned long long>(static_cast<unsigned>(n)) * d.m)
                          >> d.s);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ src, const long long* __restrict__ idx,
              float* __restrict__ out, int N, int SK, int C, int total, Div div_c,
              Div div_sk) {
  constexpr int kW = kVec ? 4 : 1;
  const int chunks = (total + kW - 1) / kW;
  for (int q = blockIdx.x * kThreads + threadIdx.x; q < chunks;
       q += gridDim.x * kThreads) {
    const int e0 = q * kW;
    int slot = divide(e0, div_c);
    int c = e0 - slot * C;
    int b = divide(slot, div_sk);
    int rem = slot - b * SK;
    long long p = __ldg(idx + slot);
    float x[kW];
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      x[j] = e0 + j < total && p >= 0 && p < N
                 ? __ldg(src + (static_cast<long long>(b) * N + p) * C + c)
                 : 0.0f;
      if (++c == C && e0 + j + 1 < total) {   // the next float is the next slot's
        c = 0;
        ++slot;
        if (++rem == SK) {
          rem = 0;
          ++b;
        }
        p = __ldg(idx + slot);
      }
    }
    if (kVec && e0 + kW <= total) {
      *reinterpret_cast<float4*>(out + e0) = make_float4(x[0], x[1], x[2], x[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kW; ++j) {
        if (e0 + j < total) out[e0 + j] = x[j];
      }
    }
  }
}

// Scatter pass 1: CTA (tile t, batch row b) counts the slots of its tile
// that hit each destination row, cnt[b][t][n] (T tiles).
__global__ void __launch_bounds__(kThreads)
scatter_count_kernel(const long long* __restrict__ idx, int* __restrict__ cnt, int N, int SK) {
  extern __shared__ int hist[];   // [N]
  const int t = blockIdx.x, b = blockIdx.y;
  for (int n = threadIdx.x; n < N; n += kThreads) hist[n] = 0;
  __syncthreads();
  const long long* idx_b = idx + static_cast<size_t>(b) * SK;
  const int i1 = min(SK, (t + 1) * kTile);
  const int lane = threadIdx.x & 31;
  long long p[kTile / kThreads];   // all of the thread's loads in flight at once
#pragma unroll
  for (int u = 0; u < kTile / kThreads; ++u) {
    const int i = t * kTile + u * kThreads + threadIdx.x;
    p[u] = i < i1 ? __ldg(idx_b + i) : -1;
  }
#pragma unroll
  for (int u = 0; u < kTile / kThreads; ++u) {
    const int row = p[u] >= 0 && p[u] < N ? static_cast<int>(p[u]) : -1;
    // one atomic per row a warp holds: the backfill puts many slots on one row
    const unsigned peers = __match_any_sync(kFull, row);
    if (row >= 0 && lane == __ffs(peers) - 1) atomicAdd(hist + row, __popc(peers));
  }
  __syncthreads();
  int* cnt_bt = cnt + (static_cast<size_t>(b) * gridDim.x + t) * N;
  for (int n = threadIdx.x; n < N; n += kThreads) cnt_bt[n] = hist[n];
}

// Exclusive scan over a batch row's N rows of value(n), each thread a
// contiguous run of rows: writes base + the prefix to out[n] and returns
// the total. Called by the whole CTA of kScanThreads.
template <typename F>
__device__ int scan_rows(F value, int* __restrict__ out, int N, int base,
                         int* warp_sum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (N + kScanThreads - 1) / kScanThreads;
  const int n0 = min(N, tid * per), n1 = min(N, n0 + per);
  int run = 0;
  for (int n = n0; n < n1; ++n) run += value(n);
  int incl = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  __syncthreads();   // warp_sum is free
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    warp_sum[lane] = w;   // inclusive over warps
  }
  __syncthreads();
  int pos = base + incl - run + (warp > 0 ? warp_sum[warp - 1] : 0);
  for (int n = n0; n < n1; ++n) {
    out[n] = pos;
    pos += value(n);
  }
  return warp_sum[kScanThreads / 32 - 1];
}

// Where a batch row's rows, segments and partial sums live in the scratch.
struct Lists {
  int* cnt;         // [B][T][N] slots of tile t in row n, then their offset in the row
  int* start;       // [B][N]    the row's first place in list
  int* len;         // [B][N]    the row's slots
  int* seg_first;   // [B][N]    the row's first segment (within its batch row)
  int* seg_total;   // [B]       segments of the batch row
  int* seg_lo;      // [B][G]    each segment's first place in list
  int* seg_len;     // [B][G]    and its slots
  int* list;        // [B*S*K]   slot ids, each row's in ascending order
  float* partial;   // [B][G][C] each segment's sums
  int G;            // segments a batch row may have: N + ceil(S*K / kSeg)
};

// Scatter pass 2: CTA b turns its counts into offsets. Row n's slots go to
// start[b][n] .. + len[b][n] of the slot list, tile t's of them cnt[b][t][n]
// (overwritten) after start[b][n]; its list splits into ceil(len / kSeg)
// segments, numbered from seg_first[b][n].
__global__ void __launch_bounds__(kScanThreads)
scatter_scan_kernel(Lists ls, int N, int T, int SK) {
  extern __shared__ int len_s[];   // [N] the rows' lengths
  __shared__ int warp_sum[kScanThreads / 32];
  const int b = blockIdx.x;
  int* cnt_b = ls.cnt + static_cast<size_t>(b) * T * N;
  int* len_b = ls.len + static_cast<size_t>(b) * N;
  // each row's tiles in order (coalesced over n), 8 loads in flight
  for (int n = threadIdx.x; n < N; n += kScanThreads) {
    int run = 0;
    for (int t0 = 0; t0 < T; t0 += 8) {
      int c[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        c[u] = t0 + u < T ? cnt_b[static_cast<size_t>(t0 + u) * N + n] : 0;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (t0 + u < T) cnt_b[static_cast<size_t>(t0 + u) * N + n] = run;
        run += c[u];
      }
    }
    len_b[n] = run;
    len_s[n] = run;
  }
  __syncthreads();
  scan_rows([&](int n) { return len_s[n]; }, ls.start + static_cast<size_t>(b) * N, N,
            b * SK, warp_sum);
  int* first_b = ls.seg_first + static_cast<size_t>(b) * N;
  const auto nseg = [&](int n) { return (len_s[n] + kSeg - 1) / kSeg; };
  const int total = scan_rows(nseg, first_b, N, 0, warp_sum);
  if (threadIdx.x == 0) ls.seg_total[b] = total;
  __syncthreads();   // start and first_b are written by other threads of the CTA
  int* lo_b = ls.seg_lo + static_cast<size_t>(b) * ls.G;
  int* seg_len_b = ls.seg_len + static_cast<size_t>(b) * ls.G;
  for (int n = threadIdx.x; n < N; n += kScanThreads) {
    const int first = first_b[n], count = nseg(n);
    const int start = ls.start[static_cast<size_t>(b) * N + n];
    for (int k = 0; k < count; ++k) {
      lo_b[first + k] = start + k * kSeg;
      seg_len_b[first + k] = min(kSeg, len_s[n] - k * kSeg);
    }
  }
}

// Scatter pass 3: CTA (tile t, batch row b) places its tile's slot ids
// (s * K + k within the batch row). It sorts the tile's (row, slot) pairs by
// row with a block radix sort, which is stable, so each row's slots stay in
// ascending order; a slot's place is then its row's start, plus the row's
// slots of earlier tiles (pass 2), plus its distance from the first of its
// row's run in the sorted tile. So each row's list comes out in ascending
// slot order, with no step that waits on another.
struct MaxOp {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};

__global__ void __launch_bounds__(kThreads)
scatter_place_kernel(const long long* __restrict__ idx, Lists ls, int N, int SK, int row_bits) {
  constexpr int kItems = kTile / kThreads;
  using Sort = cub::BlockRadixSort<int, kThreads, kItems, int>;
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ union {
    typename Sort::TempStorage sort;
    typename Scan::TempStorage scan;
  } temp;
  __shared__ int sorted_rows[kTile];
  const int t = blockIdx.x, b = blockIdx.y;
  const long long* idx_b = idx + static_cast<size_t>(b) * SK;
  const int i0 = t * kTile, tile = min(SK - i0, kTile);
  int rows[kItems], slots[kItems];   // blocked: this thread's consecutive slots
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int i = threadIdx.x * kItems + u;
    const long long p = i < tile ? __ldg(idx_b + i0 + i) : -1;
    rows[u] = p >= 0 && p < N ? static_cast<int>(p) : N;   // N: no row, sorts last
    slots[u] = i0 + i;
  }
  Sort(temp.sort).Sort(rows, slots, 0, row_bits);
#pragma unroll
  for (int u = 0; u < kItems; ++u) sorted_rows[threadIdx.x * kItems + u] = rows[u];
  __syncthreads();   // sorted_rows is written, temp.sort is free
  int first[kItems];   // the sorted position of the first slot of the item's row
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int q = threadIdx.x * kItems + u;
    first[u] = q == 0 || sorted_rows[q - 1] != rows[u] ? q : 0;
  }
  Scan(temp.scan).InclusiveScan(first, first, MaxOp());
  const int* off = ls.cnt + (static_cast<size_t>(b) * gridDim.x + t) * N;
  const int* start_b = ls.start + static_cast<size_t>(b) * N;
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int row = rows[u];
    if (row < N) {
      ls.list[start_b[row] + off[row] + threadIdx.x * kItems + u - first[u]] = slots[u];
    }
  }
}

// Scatter pass 4: warp (segment k, channel group) of batch row b sums the
// cotangents of one segment of a row's list, at most kSeg slots, into
// partial[b][k]. A group is W channels (W = 8, 16 or 32, the least that
// holds C, else 32), so a warp has Q = 32 / W streams: stream j sums the
// segment's slots j, j + Q, j + 2Q, ... in order, and the streams' sums are
// added in stream order.
__global__ void __launch_bounds__(kThreads)
scatter_partial_kernel(const float* __restrict__ g, Lists ls, int SK, int C, int W,
                       int groups) {
  const int lane = threadIdx.x & 31, b = blockIdx.y;
  const int item = blockIdx.x * kRowsPerCta + (threadIdx.x >> 5);
  const int k = item / groups;
  if (k >= ls.seg_total[b]) return;   // the whole warp
  const size_t seg = static_cast<size_t>(b) * ls.G + k;
  const int lo = ls.seg_lo[seg], count = ls.seg_len[seg];
  const int Q = 32 / W, j = lane / W, cl = lane - j * W;
  const int c = (item - k * groups) * W + cl;
  const float* g_b = g + static_cast<size_t>(b) * SK * C + c;
  float acc = 0.0f;
  int ids = lane < count ? ls.list[lo + lane] : 0;   // 32 slot ids at a time
  for (int r0 = 0; r0 < count; r0 += 32) {
    const int next = r0 + 32 + lane < count ? ls.list[lo + r0 + 32 + lane] : 0;
    const int m = min(32, count - r0);
    for (int t = 0; t < m; t += 8 * Q) {   // the same trip count on every lane
      float x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int r = t + j + u * Q;
        const int id = __shfl_sync(kFull, ids, r & 31);
        x[u] = r < m && c < C ? __ldg(g_b + id * C) : 0.0f;   // id * C < S * K * C
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (t + j + u * Q < m) acc += x[u];
      }
    }
    ids = next;
  }
  float sum = __shfl_sync(kFull, acc, cl);
  for (int q = 1; q < Q; ++q) sum += __shfl_sync(kFull, acc, q * W + cl);
  if (j == 0 && c < C) ls.partial[seg * C + c] = sum;
}

// Scatter pass 5: warp (row, group of 32 channels) adds the row's segment
// sums in segment order and writes its part of the output row once (zeros
// for a row that no slot holds).
__global__ void __launch_bounds__(kThreads)
scatter_combine_kernel(Lists ls, float* __restrict__ out, int N, int C, int groups,
                       long long items) {
  const long long item = static_cast<long long>(blockIdx.x) * kRowsPerCta + (threadIdx.x >> 5);
  if (item >= items) return;
  const int row = static_cast<int>(item / groups);
  const int c = static_cast<int>(item - static_cast<long long>(row) * groups) * 32 +
                (threadIdx.x & 31);
  if (c >= C) return;
  const int b = row / N;
  const int nseg = (ls.len[row] + kSeg - 1) / kSeg;
  const float* part = ls.partial + (static_cast<size_t>(b) * ls.G + ls.seg_first[row]) * C + c;
  float acc = 0.0f;
  for (int k = 0; k < nseg; ++k) acc += part[static_cast<size_t>(k) * C];
  out[static_cast<size_t>(row) * C + c] = acc;
}

bool bad_shape(int B, int N, int S, int K, int C) {
  return B <= 0 || N <= 0 || S <= 0 || K <= 0 || C <= 0 || N > kMaxN ||
         static_cast<long long>(B) * S * K * C > INT_MAX ||
         static_cast<long long>(B) * N * C > INT_MAX;
}

// SMs of the current device, read once per device.
int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int sms = 132;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = sms;
  }
  return cached[dev];
}

// Blocks of kThreads for `work` items, at most 8 resident blocks per SM.
int grid_for(long long work) {
  const long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = 8LL * sm_count();
  return static_cast<int>(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

// Set on every call: the default limit of 48 KB covers a kernel's static
// and dynamic shared memory together, so no test on `smem` alone is right.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

cudaError_t gather(const float* src, const long long* idx, float* out, int B, int N, int S,
                   int K, int C, cudaStream_t st) {
  const int total = B * S * K * C;
  const Div div_c = make_div(C), div_sk = make_div(S * K);
  if (reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    gather_kernel<true><<<grid_for((total + 3) / 4), kThreads, 0, st>>>(
        src, idx, out, N, S * K, C, total, div_c, div_sk);
  } else {
    gather_kernel<false><<<grid_for(total), kThreads, 0, st>>>(
        src, idx, out, N, S * K, C, total, div_c, div_sk);
  }
  return cudaGetLastError();
}

// Segments a batch row's lists may have: at most one partial segment a
// row, plus the full ones.
long long max_segments(int N, int S, int K) {
  return N + (static_cast<long long>(S) * K + kSeg - 1) / kSeg;
}

cudaError_t scatter_add(const float* g, const long long* idx, float* out, int* scratch, int B,
                        int N, int S, int K, int C, cudaStream_t st) {
  const int SK = S * K, T = (SK + kTile - 1) / kTile;
  const size_t BN = static_cast<size_t>(B) * N;
  Lists ls;
  ls.G = static_cast<int>(max_segments(N, S, K));
  ls.cnt = scratch;
  ls.start = ls.cnt + BN * T;
  ls.len = ls.start + BN;
  ls.seg_first = ls.len + BN;
  ls.seg_total = ls.seg_first + BN;
  ls.seg_lo = ls.seg_total + B;
  ls.seg_len = ls.seg_lo + static_cast<size_t>(B) * ls.G;
  ls.list = ls.seg_len + static_cast<size_t>(B) * ls.G;
  ls.partial = reinterpret_cast<float*>(ls.list + static_cast<size_t>(B) * SK);
  const size_t row_smem = static_cast<size_t>(N) * sizeof(int);
  cudaError_t err = allow_smem(scatter_count_kernel, row_smem);
  if (err == cudaSuccess) err = allow_smem(scatter_scan_kernel, row_smem);
  if (err != cudaSuccess) return err;
  int row_bits = 1;   // bits of the sort keys 0 .. N
  while ((1 << row_bits) <= N) ++row_bits;
  const dim3 tiles(T, B);
  scatter_count_kernel<<<tiles, kThreads, row_smem, st>>>(idx, ls.cnt, N, SK);
  scatter_scan_kernel<<<B, kScanThreads, row_smem, st>>>(ls, N, T, SK);
  scatter_place_kernel<<<tiles, kThreads, 0, st>>>(idx, ls, N, SK, row_bits);
  const int W = C <= 8 ? 8 : C <= 16 ? 16 : 32;
  const int groups = (C + W - 1) / W;
  const long long seg_items = static_cast<long long>(ls.G) * groups;
  scatter_partial_kernel<<<dim3(static_cast<unsigned>((seg_items + kRowsPerCta - 1) /
                                                      kRowsPerCta), B),
                           kThreads, 0, st>>>(g, ls, SK, C, W, groups);
  const int groups32 = (C + 31) / 32;
  const long long items = static_cast<long long>(BN) * groups32;
  scatter_combine_kernel<<<static_cast<unsigned>((items + kRowsPerCta - 1) / kRowsPerCta),
                           kThreads, 0, st>>>(ls, out, N, C, groups32, items);
  return cudaGetLastError();
}

}  // namespace

// src [B, N, C] f32, idx [B, S, K] int64, out [B, S, K, C] f32, contiguous
// on the current device. Returns the CUDA error of the launch (0 = success).
extern "C" int onehot_gather_launch(const float* src, const long long* idx, float* out,
                                    int B, int N, int S, int K, int C, void* stream) {
  if (bad_shape(B, N, S, K, C)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      gather(src, idx, out, B, N, S, K, C, static_cast<cudaStream_t>(stream)));
}

// 4-byte words of scratch the scatter-add needs for C channels: per-tile
// counts [B, T, N] (T tiles of kTile slots), row starts, lengths and first
// segments [B, N] each, segment totals [B], segment starts and lengths
// [B, G] each, the slot list [B, S, K] and the segments' sums [B, G, C]
// (G = max_segments).
extern "C" long long onehot_scatter_add_scratch_ints(int B, int N, int S, int K, int C) {
  const long long T = (static_cast<long long>(S) * K + kTile - 1) / kTile;
  const long long G = max_segments(N, S, K);
  return static_cast<long long>(B) * (N * (T + 3) + 1 + G * (2 + C) +
                                      static_cast<long long>(S) * K);
}

// g [B, S, K, C] f32, idx [B, S, K] int64, out [B, N, C] f32 (every element
// written), scratch of onehot_scatter_add_scratch_ints ints; contiguous on
// the current device. Returns the CUDA error (0 = success).
extern "C" int onehot_scatter_add_launch(const float* g, const long long* idx, float* out,
                                         int* scratch, int B, int N, int S, int K, int C,
                                         void* stream) {
  if (bad_shape(B, N, S, K, C)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(scatter_add(g, idx, out, scratch, B, N, S, K, C,
                                      static_cast<cudaStream_t>(stream)));
}
