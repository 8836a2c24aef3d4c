// One MSG scale pooled over each centroid's selected points, on Hopper
// (sm_90a), with the chain on tensor cores at float32 accuracy. The kernel
// has two selection stages over one chain: the ball mode selects in the
// kernel from the coordinates, the mask mode reads the selection from a mask.
//
// Replaces four TPU kernels of ev2hands_tpu/ops/pallas_grouping.py that
// compute one function: fused_msg_scale_pallas (_kernel_fused) and
// dense_msg_scale_pallas (_kernel) in the ball mode,
// dense_msg_scale_pallas_2d (_kernel_2d) and
// dense_msg_scale_pallas_2d_batched (_kernel_2d_batched) in the mask mode.
// For each (b, s)
//   out[b, s, c] = max over the selected points n of
//                  relu(relu(relu(u[b, n] - v[b, s]) @ W2 + b2) @ W3 + b3)[c]
// over u [B, N, C1], v [B, S, C1], W2 [C1, C2], W3 [C2, C3]. The ball mode
// selects the first nsample points by index whose squared distance to the
// centroid is <= r2, and point 0 alone for an empty ball. The mask mode
// selects the points n with sel[b, s, n] > 0.5 (sel [B, S, N] f32 in
// original point order), any number of them, and writes -1e30 where it
// selects none, as the TPU kernels do (their masked rows add h - 1e30,
// which is -1e30 in f32).
//
// Selection exactness (ball mode): d2 = ((cx - x)^2 + (cy - y)^2) + (cz - z)^2
// with one rounding per operation (__fsub_rn, __fmul_rn, __fadd_rn: never
// contracted into an FMA), the order of _kernel_fused and of the plain
// version, against r2 rounded once to f32 by the caller; ranks come from
// ballots in index order, so the first nsample are the plain version's.
//
// What bounds it on this card: 2 * (C1 * C2 + C2 * C3) flops for each
// selected pair, against u, v, the weights, the output and xyz or the mask
// read or written once. At sa1's and the regressor heads' widths the
// operations bound the widest scales: in f32 outside the tensor cores (67
// TFLOP/s) the sa1 pass needs ~0.26 ms; on the tensor cores in TF32 (495
// TFLOP/s dense), at three TF32 products for each f32 product (below),
// ~0.11 ms. The narrow sa1 scales are bound by the selection: the ball
// mode's walk over the points, and in the mask mode the mask's bytes (67 MB
// a scale at B = 16, S = 512, N = 2048: 0.020 ms at 3.35 TB/s).
// Measured (chip_smoke.py phase 4c, one H100): the MMAs of the widest sa1
// scale take two thirds of its time at ~10 cycles a warp-level m16n8k8
// TF32 MMA on each SM sub-partition, about half the TF32 peak that the
// bound assumes (wgmma's); the walk, the z pass and the epilogues most of
// the rest.
//
// Design. A CTA of 16 warps takes a tile of centroids of one batch row (the
// most of 32, 16, 8 whose CTAs still fill the SMs, else 4; phase 4c sweeps
// it: 32 at sa1's S = 512, 8 at the heads' S = 128).
//  1. Selection, ball mode. xyz[b] is staged in shared memory in chunks of
//     2,048 or more points (cp.async, then one float4 a point), and each
//     warp walks its centroids, two at a time, 128 points a step with
//     __ballot_sync / __popc, leaving a centroid once nsample are found: no
//     CTA barrier in the walk, only one between chunks (a CTA whose balls
//     are all full stops there).
//  1'. Selection, mask mode: the mask walk. Each warp reads its two
//     centroids' mask rows from device memory, 128 points a step (a 16-byte
//     load a lane, lane l holding points 4l .. 4l + 3), two steps of both
//     in flight; four ballots on > 0.5f rank the selected points, which go
//     to the centroid's segment in ascending index order. No early exit:
//     the whole row is read. The segments lie in the z/h region, which is
//     free until the chain, and hold kc rows each, kc fixed by the plan from
//     the shared memory left over (at least 128, the most a step selects,
//     or N). A step is taken whole or not at all: where it does not fit,
//     the centroid's walk stops at the step, the CTA runs steps 2-5 over the
//     rows packed so far, and the walk resumes there; passes repeat until
//     every row is read, the running max carried across them. Each pass's
//     list is in centroid order. A centroid with no row in any pass writes
//     -1e30. (Staging the mask's [tile, chunk] box with a bulk asynchronous
//     copy, to overlap the next chunk's read with the chain, is untried.)
//  2. Rows packed across the tile. Each centroid's indices go to its own
//     segment; a warp scan over the counts gives each centroid's offset,
//     and the rows of all the tile's centroids are packed into one list in
//     centroid order. The chain runs over that list 128 rows at a time (64
//     for outputs over 128 wide), so only the last row tile of a CTA is
//     ragged (the TPU kernels and the previous CUDA kernel padded each ball
//     to its own blocks). A row tile's u rows are gathered with cp.async
//     while the previous tile's second layer runs. With streamed weights
//     only its issue overlaps: the first panel of layer 2 waits for every
//     older cp.async group, the gather too. Issuing it with the last panel
//     of layer 2 instead measured no faster at the heads' scales
//     (ball_phases.py): a row tile's wait is 0.5-1.6% of a CTA there.
//  3. Weights in shared memory. W2, W3 and their biases are loaded once per
//     CTA and serve every row tile, transposed so that an MMA fragment's two
//     values along the input channels are one 8-byte load. Where they do not
//     fit beside the tiles (the heads' (128, 128, 256) and (128, 196, 256)
//     scales: 190-300 KB of weights against the 227 KB a CTA may use), they
//     stream through two slots of 32 weight rows (k-panels) per row tile
//     with cp.async, the next panel in flight while one is used. Widths are
//     padded to multiples of 8 with zero weights and biases (C2 = 196 ->
//     200): relu(0) = 0 meets zero rows of W3, so the result does not
//     change.
//  4. The chain on tensor cores. z = relu(u[row] - v[centroid]) and the
//     first layer's output stay in shared memory; both layers run mma.sync
//     m16n8k8 TF32 in the 3xTF32 split: each operand a = hi + lo with hi
//     rounded to TF32 to nearest, ties away from zero (cvt.rna's rule, with
//     an integer add and mask) and lo = a - hi (exact; the MMA reads its
//     top 19 bits), and acc += lo * hi' + hi * lo' + hi * hi' in f32. One
//     TF32 product keeps ~3 digits (1e-3 off at these widths); the split
//     keeps ~1e-6 (tests/test_torch_ball_precision.py emulates it on the
//     CPU). A warp holds 32 rows x 4 MMA tiles of 8 columns, so each A
//     fragment it splits serves 4 of them. Warp-level mma.sync and not
//     wgmma: the A tile is a gather, which TMA cannot make, C1 is only
//     32-128, and a CTA has one or two row tiles at the narrow scales.
//  5. The max in the epilogue: bias and relu in registers; where a warp's
//     32 rows hold one or two centroids (rows are in centroid order, so
//     their first and last centroid differ by at most one) a thread folds
//     its 4 rows and 3 shuffles finish each max, else a segmented max over
//     each 8-row group with shuffles; then one integer atomicMax on the
//     float bits a segment into the tile's running max in shared memory:
//     exact in any order, since every value is a relu output (>= +0.0).
//     The running max starts at +0.0, which a centroid with at least one
//     row never keeps above its max; [B, S, C3] is written once.
// The sums run in another order than an f32 FMA chain, so this kernel
// agrees with msg_dense.cu's block-sparse kernel within 1e-4 on the same
// rows, not bitwise. Both modes, two launches, and any two tiles of
// centroids agree bitwise on the same rows (a row's sums do not depend on
// the rows beside it, each layout runs the same products in the
// same order, and no order depends on timing).
//
// Built with -DMSG_BALL_PHASES (ball_phases.py), thread 0 of each CTA adds
// the clock64() cycles between PHASE marks into g_phase, which
// msg_ball_phases reads; otherwise the marks are empty. Barrier waits fall
// in the phase that ends at the barrier; a mask mode's passes add up.

#include <cuda_runtime.h>
#include <stdint.h>

#ifdef MSG_BALL_PHASES
// cycles by phase (0-9: set-up, walk, pack, tile wait, z pass, layer 1,
// epilogue 1 and the next gather's issue, layer 2, epilogue 2, output),
// summed over CTAs; 10: the CTAs
__device__ unsigned long long g_phase[16];
#define PHASE_START long long phase_t_ = clock64();
#define PHASE(i)                                                            \
  if (threadIdx.x == 0) {                                                   \
    const long long now_ = clock64();                                       \
    atomicAdd(&g_phase[i], static_cast<unsigned long long>(now_ - phase_t_)); \
    phase_t_ = now_;                                                        \
  }
#else
#define PHASE_START
#define PHASE(i)
#endif

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kNT = 4;            // 8-column MMA tiles a warp holds of a layer's output
constexpr int kPanel = 32;        // weight rows of a streamed panel
constexpr int kMaxTile = 32;      // centroids of a CTA
constexpr int kMaxC1 = 128;
constexpr int kMaxC2 = 256;
constexpr int kMaxC3 = 256;
constexpr int kMaxChunk = 2048;   // a walk chunk has room for this many points at least
constexpr int kStep = 128;        // points a warp reads a step of a walk
constexpr int kAhead = 2;         // steps of a centroid's mask row in flight
constexpr int kCodeBits = 24;     // a row's code: centroid << 24 | point
// dynamic shared memory a CTA may use, less the static arrays below
constexpr size_t kSmemLimit = 232448 - 1024;

// Layout of a launch. The 16 warps form a (16 / wn) x wn grid (4 x 4 for
// outputs up to 128 wide, 2 x 8 for wider); a warp holds 32 rows x kNT MMA
// tiles, so a row tile has rows = 32 * (16 / wn) rows. z and h tiles keep
// each group of 8 channels in the order 0 4 1 5 2 6 3 7 (pk), and resident
// weights lie transposed ([out][in]) in that order too, so an MMA fragment's
// two values along the input channels are one 8-byte load. Strides in
// floats are 8 mod 16 (those loads conflict-free; the streamed panels'
// row-major [in][out] reads too). Offsets in floats, each a multiple of 32.
// kc: the rows a centroid's segment holds (a pass's rows in the mask mode);
// vecx: the selection's input (xyz, or the mask) is read 16 bytes at a
// time. (A field more measured slower: ptxas then recomputed the 3xTF32
// split of the A fragments in the ball mode's resident-weight loops.)
struct Plan {
  int c1, c2, c3, c1p, c2p, c3p;
  int wn, rows;
  int ldz, ldh, ld2, ld3, ldp;
  int tile, kc, stream, chunk;
  int vec2, vec3, vecu, vecv, vecx;
  int o_w3, o_b2, o_b3, o_v, o_z, o_h, o_mx, o_seg, o_codes;
  int floats;
};

int up(int x, int m) { return (x + m - 1) / m * m; }
int stride(int x) { return x % 16 == 0 ? x + 8 : x; }   // x a multiple of 8

// Fills the layout for widths (c1, c2, c3), N points, nsample (0: the mask
// mode) and `tile` centroids a CTA, weights resident or streamed; false if
// it does not fit.
bool layout(int c1, int c2, int c3, int N, int nsample, int tile, int stream, Plan* p) {
  const bool mask = nsample == 0;
  Plan q{};
  q.c1 = c1; q.c2 = c2; q.c3 = c3;
  q.c1p = up(c1, 8); q.c2p = up(c2, 8); q.c3p = up(c3, 8);
  q.wn = (q.c2p > 128 || q.c3p > 128) ? 8 : 4;
  q.rows = 32 * (kWarps / q.wn);
  q.ldz = stride(q.c1p); q.ldh = stride(q.c2p);
  q.tile = tile; q.kc = nsample < N ? nsample : N; q.stream = stream;
  size_t o = 0;
  if (stream) {   // two slots of kPanel weight rows, row-major
    q.ldp = stride(q.c2p > q.c3p ? q.c2p : q.c3p);
    o = static_cast<size_t>(2) * kPanel * q.ldp;
  } else {        // W2 [c2p][ld2] at 0, W3 [c3p][ld3], transposed
    q.ld2 = stride(q.c1p); q.ld3 = stride(q.c2p);
    q.o_w3 = q.c2p * q.ld2;
    o = static_cast<size_t>(q.o_w3) + static_cast<size_t>(q.c3p) * q.ld3;
  }
  if (o > kSmemLimit / 4) return false;
  auto take = [&](size_t n) {   // n floats at the next multiple of 32
    const size_t at = (o + 31) / 32 * 32;
    o = at + n;
    return static_cast<int>(at);
  };
  q.o_b2 = take(q.c2p);
  q.o_b3 = take(q.c3p);
  q.o_v = take(static_cast<size_t>(tile) * q.c1p);
  // z and h tiles; during the ball walk, a chunk of xyz as float4 (x, y,
  // z, 0) and, behind it, as copied (x, y, z interleaved): 7 floats a
  // point; during the mask walk, the segments
  const size_t zh = static_cast<size_t>(q.rows) * (q.ldz + q.ldh);
  const int want = up(N < kMaxChunk ? N : kMaxChunk, 32);
  const size_t region =
      mask || zh > static_cast<size_t>(7) * want ? zh : static_cast<size_t>(7) * want;
  q.o_z = take(region);
  q.o_h = q.o_z + q.rows * q.ldz;
  q.chunk = mask ? 0 : static_cast<int>(region / 7 / 32 * 32);
  if (q.chunk > up(N, 32)) q.chunk = up(N, 32);
  q.o_mx = take(static_cast<size_t>(tile) * c3);
  if (mask) {   // segments in the z/h region; the list takes what is left
    const size_t at = (o + 31) / 32 * 32;
    size_t kc = at < kSmemLimit / 4 ? (kSmemLimit / 4 - at) / tile : 0;
    if (kc > region / tile) kc = region / tile;
    if (kc > static_cast<size_t>(N)) kc = N;
    if (kc < static_cast<size_t>(N < kStep ? N : kStep)) return false;
    q.kc = static_cast<int>(kc);
    q.o_seg = q.o_z;
  } else {
    if (static_cast<size_t>(tile) * q.kc > kSmemLimit / 8) return false;
    q.o_seg = take(static_cast<size_t>(tile) * q.kc);
  }
  q.o_codes = take(static_cast<size_t>(tile) * q.kc);
  o = (o + 31) / 32 * 32;
  if (o * 4 > kSmemLimit) return false;
  q.floats = static_cast<int>(o);
  *p = q;
  return true;
}

// The layout a launch uses: the weights resident with the most centroids
// up to `tile`, else streamed likewise. tile 0: the largest of 32, 16, 8
// whose CTAs (B * ceil(S / tile)) fill the card's SMs, else 4 (phase 4c's
// sweep: 32 is best at sa1's S = 512, B = 16; at the heads' S = 128 it
// leaves half the SMs idle). Both modes by the same rule; nsample 0 is the
// mask mode, whose shared memory does not grow with N or a selection.
bool plan(int c1, int c2, int c3, int B, int S, int N, int nsample, int tile, Plan* p) {
  if (c1 < 1 || c1 > kMaxC1 || c2 < 1 || c2 > kMaxC2 || c3 < 1 || c3 > kMaxC3 ||
      B < 1 || S < 1 || N < 1 || N >= (1 << kCodeBits) || nsample < 0 || tile < 0 ||
      tile > kMaxTile) {
    return false;
  }
  if (tile == 0) {
    static int sms = 0;   // the SMs of the first device asked
    if (sms == 0) {
      int dev = 0, n = 0;
      sms = cudaGetDevice(&dev) == cudaSuccess &&
                    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) ==
                        cudaSuccess
                ? n
                : 132;
    }
    tile = 4;
    for (int t = kMaxTile; t > 4; t /= 2) {
      if (static_cast<long long>(B) * ((S + t - 1) / t) >= sms) {
        tile = t;
        break;
      }
    }
  }
  for (int stream = 0; stream < 2; ++stream) {
    for (int t = tile; t >= 1; --t) {
      if (layout(c1, c2, c3, N, nsample, t, stream, p)) return true;
    }
  }
  return false;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n floats from src to dst (both 16-byte aligned where vec), asynchronously.
__device__ __forceinline__ void copy_floats(float* dst, const float* __restrict__ src, int n,
                                            int vec) {
  int done = 0;
  if (vec) {
    done = n / 4 * 4;
    for (int i = threadIdx.x * 4; i < done; i += kThreads * 4) cp_async16(dst + i, src + i);
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads) cp_async4(dst + i, src + i);
}

// Rows k0 .. k0 + nrows of W [cin, cout] (row-major) into dst [nrows][ldd],
// columns 0 .. coutp, asynchronously; rows >= cin and columns >= cout are
// zero. vec: cout is a multiple of 4 and W 16-byte aligned.
__device__ void copy_rows(float* dst, int ldd, const float* __restrict__ W, int k0,
                          int nrows, int cin, int cout, int coutp, int vec) {
  if (vec) {
    const int q4 = coutp / 4;
    for (int e = threadIdx.x; e < nrows * q4; e += kThreads) {
      const int r = e / q4, c = (e - r * q4) * 4;
      float* d = dst + r * ldd + c;
      if (k0 + r < cin && c < cout) {
        cp_async16(d, W + static_cast<size_t>(k0 + r) * cout + c);
      } else {
        *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  } else {
    for (int e = threadIdx.x; e < nrows * coutp; e += kThreads) {
      const int r = e / coutp, c = e - r * coutp;
      float* d = dst + r * ldd + c;
      if (k0 + r < cin && c < cout) {
        cp_async4(d, W + static_cast<size_t>(k0 + r) * cout + c);
      } else {
        *d = 0.0f;
      }
    }
  }
}

// Where channel k lies in its group of 8: 0 4 1 5 2 6 3 7, so channels k and
// k + 4 (k % 8 < 4) are neighbours.
__device__ __forceinline__ int pk(int k) {
  const int c = k & 7;
  return (k & ~7) | (c < 4 ? 2 * c : 2 * c - 7);
}

// W [cin, cout] (row-major) into Wt [coutp][ld] transposed, each row's
// channels in pk order; zero beyond cin and cout. A warp writes 4 input
// channels x 8 outputs at a time: 32-byte reads, 2-way bank conflicts.
__device__ void load_transposed(float* Wt, int ld, const float* __restrict__ W, int cin,
                                int cout, int cinp, int coutp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nbk = cinp / 4, nbn = coutp / 8;
  for (int u = warp; u < nbk * nbn; u += kWarps) {
    const int k = (u % nbk) * 4 + (lane >> 3), n = (u / nbk) * 8 + (lane & 7);
    Wt[n * ld + pk(k)] = k < cin && n < cout ? __ldg(W + static_cast<size_t>(k) * cout + n)
                                             : 0.0f;
  }
}

// hi + lo = x with hi x rounded to TF32 (10 mantissa bits, to nearest, ties
// away from zero: cvt.rna.tf32.f32's rule for finite x) and lo = x - hi,
// exact; the MMA reads lo's top 19 bits (lo truncated to TF32).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a * b over one m16n8k8 TF32 tile, f32 accumulation.
__device__ __forceinline__ void mma(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += A[:, a0 .. a0 + kp] @ W in the 3xTF32 split, kp a multiple of 8;
// A [rows][lda] in pk order. W is resident and transposed (T: Wt [n][ldw]
// in pk order, all kp input channels) or a streamed panel (Wp [kp][ldw]
// row-major). Warp (wm, wn) takes rows wm * 32 .. + 31 (two MMA tiles) and
// the MMA tiles wn + WN j, j < kNT, below `ntiles`.
template <int WN, bool T>
__device__ __forceinline__ void mma_panel(float (&acc)[2][kNT][4], const float* A, int lda,
                                          int a0, const float* W, int ldw, int kp,
                                          int ntiles, int wm, int wn, int g, int t) {
  for (int ks = 0; ks < kp; ks += 8) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float* a = A + (wm * 32 + mi * 16 + g) * lda + a0 + ks + 2 * t;
      const float2 x02 = *reinterpret_cast<const float2*>(a);
      const float2 x13 = *reinterpret_cast<const float2*>(a + 8 * lda);
      split(x02.x, ah[mi][0], al[mi][0]);
      split(x13.x, ah[mi][1], al[mi][1]);
      split(x02.y, ah[mi][2], al[mi][2]);
      split(x13.y, ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int nt = wn + WN * j;
      if (nt < ntiles) {
        float2 w;
        if (T) {
          w = *reinterpret_cast<const float2*>(W + (nt * 8 + g) * ldw + ks + 2 * t);
        } else {
          const float* wp = W + (ks + t) * ldw + nt * 8 + g;
          w = make_float2(wp[0], wp[4 * ldw]);
        }
        uint32_t bh[2], bl[2];
        split(w.x, bh[0], bl[0]);
        split(w.y, bh[1], bl[1]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma(acc[mi][j], al[mi], bh);
          mma(acc[mi][j], ah[mi], bl);
          mma(acc[mi][j], ah[mi], bh);
        }
      }
    }
  }
}

__device__ __forceinline__ float relu(float y) { return y > 0.0f ? y : 0.0f; }

// Bit h set where point i + h (h < 4) of a mask row is selected (> 0.5f);
// none past N. vec: the row lies on 16 bytes and N is a multiple of 4, so
// the 4 points are one 16-byte load. Streaming loads: each value is read
// once.
__device__ __forceinline__ unsigned mask_bits(const float* __restrict__ row, int i, int N,
                                              int vec) {
  if (vec) {
    if (i >= N) return 0u;
    const float4 x = __ldcs(reinterpret_cast<const float4*>(row + i));
    return static_cast<unsigned>(x.x > 0.5f) | static_cast<unsigned>(x.y > 0.5f) << 1 |
           static_cast<unsigned>(x.z > 0.5f) << 2 | static_cast<unsigned>(x.w > 0.5f) << 3;
  }
  unsigned bits = 0u;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    if (i + h < N && __ldcs(row + i + h) > 0.5f) bits |= 1u << h;
  }
  return bits;
}

// MASK: the mask mode (sel; xyz, new_xyz, r2 and nsample unused), else the
// ball mode (sel unused).
template <int WN, bool STREAM, bool MASK>
__global__ void __launch_bounds__(kThreads, 1)
msg_ball_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                const float* __restrict__ sel, const float* __restrict__ u,
                const float* __restrict__ v, const float* __restrict__ W2,
                const float* __restrict__ b2, const float* __restrict__ W3,
                const float* __restrict__ b3, float* __restrict__ out, int S, int N, float r2,
                int nsample, const Plan p) {
  extern __shared__ __align__(128) float smem[];
  __shared__ float cen[kMaxTile * 3];
  __shared__ int cnt[kMaxTile];
  __shared__ int off[kMaxTile + 1];
  __shared__ int pos[kMaxTile];    // the mask mode: where a centroid's walk resumes
  __shared__ int seen[kMaxTile];   // the mask mode: 1 once a centroid has had a row
  float* const b2s = smem + p.o_b2;
  float* const b3s = smem + p.o_b3;
  float* const V = smem + p.o_v;
  float* const Z = smem + p.o_z;
  float* const H = smem + p.o_h;
  int* const mx = reinterpret_cast<int*>(smem + p.o_mx);
  int* const seg = reinterpret_cast<int*>(smem + p.o_seg);
  int* const codes = reinterpret_cast<int*>(smem + p.o_codes);

  PHASE_START
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, s0 = blockIdx.x * p.tile;
  const int nc = min(p.tile, S - s0);
  const float* u_b = u + static_cast<size_t>(b) * N * p.c1;
  const float* v_t = v + (static_cast<size_t>(b) * S + s0) * p.c1;

  // the k-panels of a row tile when streamed: W2's, then W3's
  const int np1 = (p.c1p + kPanel - 1) / kPanel, np2 = (p.c2p + kPanel - 1) / kPanel;
  const int np = np1 + np2;
  auto issue = [&](int q) {   // streamed panel q into slot q & 1 (its own group)
    const int i = q % np;
    float* slot = smem + (q & 1) * kPanel * p.ldp;
    if (i < np1) {
      const int k0 = i * kPanel;
      copy_rows(slot, p.ldp, W2, k0, min(kPanel, p.c1p - k0), p.c1, p.c2, p.c2p, p.vec2);
    } else {
      const int k0 = (i - np1) * kPanel;
      copy_rows(slot, p.ldp, W3, k0, min(kPanel, p.c2p - k0), p.c2, p.c3, p.c3p, p.vec3);
    }
    cp_async_commit();
  };
  // in flight first: in the ball mode xyz's first chunk (one group; the
  // walk's chunk as copied, then as float4, one 16-byte load a point), then
  // v of the tile's centroids (with the first panel when streamed)
  float* const raw = Z + 4 * p.chunk;
  float4* const pts = reinterpret_cast<float4*>(Z);
  const float* x_b = MASK ? nullptr : xyz + static_cast<size_t>(b) * N * 3;
  if constexpr (!MASK) {
    copy_floats(raw, x_b, 3 * min(p.chunk, N), p.vecx);
    cp_async_commit();
  }
  copy_rows(V, p.c1p, v_t, 0, nc, nc, p.c1, p.c1p, p.vecv);
  if (STREAM) {
    issue(0);
  } else {
    cp_async_commit();
    load_transposed(smem, p.ld2, W2, p.c1, p.c2, p.c1p, p.c2p);
    load_transposed(smem + p.o_w3, p.ld3, W3, p.c2, p.c3, p.c2p, p.c3p);
  }
  for (int i = tid; i < p.c2p; i += kThreads) b2s[i] = i < p.c2 ? b2[i] : 0.0f;
  for (int i = tid; i < p.c3p; i += kThreads) b3s[i] = i < p.c3 ? b3[i] : 0.0f;
  for (int i = tid; i < nc * p.c3; i += kThreads) mx[i] = 0;   // +0.0f: relu outputs
  if constexpr (!MASK) {
    for (int i = tid; i < nc * 3; i += kThreads) {
      cen[i] = new_xyz[(static_cast<size_t>(b) * S + s0) * 3 + i];
    }
  }
  if (tid < nc) {
    cnt[tid] = 0;
    pos[tid] = 0;
    seen[tid] = 0;
  }

  PHASE(0)
  // 1'. the mask walk: a warp takes centroids c and c + kWarps (tile <= 32)
  // together, from where each stopped, two steps of each in flight -> some
  // walk stopped on a full segment
  auto mask_walk = [&]() -> bool {
    __syncthreads();   // pos is published, the last pass is done with Z
    bool stopped = false;
    const unsigned lt = (1u << lane) - 1u;
    for (int c = warp; c < nc; c += 2 * kWarps) {
      const int cs[2] = {c, c + kWarps < nc ? c + kWarps : -1};
      const float* row[2];
      int at[2], count[2] = {0, 0};
      bool go[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int cm = cs[m] < 0 ? c : cs[m];
        row[m] = sel + (static_cast<size_t>(b) * S + s0 + cm) * N;
        at[m] = cs[m] < 0 ? N : pos[cm];
        go[m] = at[m] < N;
      }
      while (go[0] || go[1]) {
        unsigned bits[2][kAhead];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int k = 0; k < kAhead; ++k) {
            bits[m][k] = go[m] ? mask_bits(row[m], at[m] + kStep * k + 4 * lane, N, p.vecx)
                               : 0u;
          }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int k = 0; k < kAhead; ++k) {
            if (!go[m]) continue;   // the same for the whole warp
            // lane l's selected points follow those of lanes below it
            int n = 0, before = 0;
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              const unsigned ballot = __ballot_sync(0xffffffffu, (bits[m][k] >> h) & 1u);
              n += __popc(ballot);
              before += __popc(ballot & lt);
            }
            if (count[m] + n > p.kc) {   // the step waits for the next pass
              go[m] = false;
              stopped = true;
              continue;
            }
            int* d = seg + cs[m] * p.kc + count[m] + before;
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              if ((bits[m][k] >> h) & 1u) *d++ = at[m] + 4 * lane + h;
            }
            count[m] += n;
            at[m] += kStep;
            go[m] = at[m] < N;
          }
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (cs[m] >= 0) {
            cnt[cs[m]] = count[m];
            pos[cs[m]] = at[m];
          }
        }
      }
    }
    return __syncthreads_or(stopped);
  };
  // 1. the ball walk, chunk by chunk of xyz[b]; a warp takes 128 points a step
  auto ball_walk = [&]() {
    for (int p0 = 0; p0 < N; p0 += p.chunk) {
      const int pn = min(p.chunk, N - p0);
      if (p0 == 0) {
        cp_async_wait<1>();   // the chunk, not v or the panel
      } else {
        __syncthreads();      // the previous chunk is walked
        copy_floats(raw, x_b + static_cast<size_t>(p0) * 3, 3 * pn, p.vecx);
        cp_async_commit();
        cp_async_wait<0>();
      }
      __syncthreads();
      for (int i = tid; i < pn; i += kThreads) {
        pts[i] = make_float4(raw[3 * i], raw[3 * i + 1], raw[3 * i + 2], 0.0f);
      }
      __syncthreads();
      // a warp walks centroids c and c + kWarps together (tile <= 32): one
      // load a point serves both, and their chains interleave
      bool full = true;
      for (int c = warp; c < nc; c += 2 * kWarps) {
        const int cs[2] = {c, c + kWarps < nc ? c + kWarps : -1};
        int count[2];
        bool act[2];
        float cx[2], cy[2], cz[2];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int cm = cs[m] < 0 ? c : cs[m];
          count[m] = cs[m] < 0 ? nsample : cnt[cm];
          cx[m] = cen[3 * cm];
          cy[m] = cen[3 * cm + 1];
          cz[m] = cen[3 * cm + 2];
        }
        const unsigned lt = (1u << lane) - 1u;
        for (int i0 = 0; i0 < pn; i0 += kStep) {
          act[0] = count[0] < nsample;
          act[1] = count[1] < nsample;
          if (!act[0] && !act[1]) break;
          bool in[2][4];
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int i = i0 + 32 * h + lane;
            const float4 x = pts[i < pn ? i : 0];
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              const float dx = __fsub_rn(cx[m], x.x);
              const float dy = __fsub_rn(cy[m], x.y);
              const float dz = __fsub_rn(cz[m], x.z);
              const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                         __fmul_rn(dz, dz));
              in[m][h] = i < pn && d2 <= r2;
            }
          }
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            if (!act[m]) continue;   // the same for the whole warp
            int* segc = seg + cs[m] * p.kc;
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              const unsigned ballot = __ballot_sync(0xffffffffu, in[m][h]);
              const int rank = count[m] + __popc(ballot & lt);
              if (in[m][h] && rank < nsample) segc[rank] = p0 + i0 + 32 * h + lane;
              count[m] += __popc(ballot);
            }
          }
        }
        if (lane == 0) {
          cnt[c] = count[0];
          if (cs[1] >= 0) cnt[cs[1]] = count[1];
        }
        full = full && count[0] >= nsample && count[1] >= nsample;
      }
      if (__syncthreads_and(full)) break;
    }
  };
  // 2. pack the rows -> the rows of the list: offsets by a warp scan (in the
  // ball mode an empty ball keeps one row, point 0; in the mask mode a
  // centroid may have none)
  auto pack = [&]() -> int {
    if (warp == 0) {
      int n = 0;
      if (lane < nc) {
        n = MASK ? cnt[lane] : min(cnt[lane], nsample);
        if (!MASK && n == 0) n = 1;
        if (MASK && n > 0) seen[lane] = 1;
      }
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int o = __shfl_up_sync(0xffffffffu, n, d);
        if (lane >= d) n += o;
      }
      if (lane < nc) off[lane + 1] = n;
      if (lane == 0) off[0] = 0;
    }
    __syncthreads();
    for (int c = warp; c < nc; c += kWarps) {
      const int n = MASK ? cnt[c] : min(cnt[c], nsample), base = off[c];
      if (!MASK && n == 0) {
        if (lane == 0) codes[base] = c << kCodeBits;   // point 0
      } else {
        for (int i = lane; i < n; i += 32) codes[base + i] = (c << kCodeBits) | seg[c * p.kc + i];
      }
    }
    const int total = off[nc];
    __syncthreads();
    return total;
  };
  // 3-5. the chain over the `total` packed rows, p.rows at a time, into the
  // running max
  auto chain = [&](const int total) {
    // u's rows of the row tile at r0 into Z as they are, asynchronously (one group)
    auto gather = [&](int r0) {
      const int rows = min(p.rows, total - r0);
      if (p.vecu) {
        const int q4 = p.c1 / 4;
        for (int e = tid; e < rows * q4; e += kThreads) {
          const int r = e / q4, k = (e - r * q4) * 4;
          const int n = codes[r0 + r] & ((1 << kCodeBits) - 1);
          cp_async16(Z + r * p.ldz + k, u_b + static_cast<size_t>(n) * p.c1 + k);
        }
      } else {
        for (int e = tid; e < rows * p.c1; e += kThreads) {
          const int r = e / p.c1, k = e - r * p.c1;
          const int n = codes[r0 + r] & ((1 << kCodeBits) - 1);
          cp_async4(Z + r * p.ldz + k, u_b + static_cast<size_t>(n) * p.c1 + k);
        }
      }
      cp_async_commit();
    };

    const int wm = warp / WN, wn = warp % WN, g = lane >> 2, t = lane & 3;
    const int nt2 = p.c2p / 8, nt3 = p.c3p / 8;
    const int npanels = (total + p.rows - 1) / p.rows * np;
    int q = 0;   // the streamed panel in use (panel 0 is in flight)
    // a streamed panel: issue the next, wait for this one -> its slot
    auto acquire = [&]() -> const float* {
      if (q + 1 < npanels) {
        issue(q + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      return smem + (q & 1) * kPanel * p.ldp;
    };
    const int q4 = p.c1p / 4;
    float acc[2][kNT][4];
    gather(0);
    for (int r0 = 0; r0 < total; r0 += p.rows) {
      const int rows = min(p.rows, total - r0);
      cp_async_wait<0>();   // this tile's rows (and v)
      __syncthreads();
      PHASE(3)
      // z = relu(u - v) in place, each group of 8 channels into pk order;
      // padding rows and channels 0. A thread takes 4 channels (one float4,
      // 8 lanes on 32 banks) and trades 2 with its partner lane, which holds
      // the other half of the group. Every warp takes part in each pass
      // (p.rows * q4 is a multiple of 32), as the shuffle needs.
      for (int e = tid; e < p.rows * q4; e += kThreads) {
        const int r = e / q4, k = (e - r * q4) * 4, h = (k >> 2) & 1;
        float* zr = Z + r * p.ldz + k;
        float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (r < rows) {
          const float4 x = *reinterpret_cast<const float4*>(zr);
          const float4 w = *reinterpret_cast<const float4*>(
              V + (codes[r0 + r] >> kCodeBits) * p.c1p + k);
          z = make_float4(k < p.c1 ? relu(x.x - w.x) : 0.0f,
                          k + 1 < p.c1 ? relu(x.y - w.y) : 0.0f,
                          k + 2 < p.c1 ? relu(x.z - w.z) : 0.0f,
                          k + 3 < p.c1 ? relu(x.w - w.w) : 0.0f);
        }
        // channels 0-3 (h = 0) become 0 4 1 5, channels 4-7 become 2 6 3 7
        const float o0 = __shfl_xor_sync(0xffffffffu, h ? z.x : z.z, 1);
        const float o1 = __shfl_xor_sync(0xffffffffu, h ? z.y : z.w, 1);
        *reinterpret_cast<float4*>(zr) =
            h ? make_float4(o0, z.z, o1, z.w) : make_float4(z.x, o0, z.y, o1);
      }
      __syncthreads();

      PHASE(4)
      // layer 1 -> H (pk order)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;
      if (STREAM) {
        for (int i = 0; i < np1; ++i, ++q) {
          const float* Wp = acquire();
          const int k0 = i * kPanel;
          mma_panel<WN, false>(acc, Z, p.ldz, k0, Wp, p.ldp, min(kPanel, p.c1p - k0), nt2,
                               wm, wn, g, t);
          __syncthreads();   // the slot is free for the panel after next
        }
      } else {
        mma_panel<WN, true>(acc, Z, p.ldz, 0, smem, p.ld2, p.c1p, nt2, wm, wn, g, t);
      }
      PHASE(5)
      // h = relu(acc + b2) into H in pk order: lanes t and t ^ 2 hold
      // channels that are neighbours there (t < 2: 2t, 2t + 1; t ^ 2: + 4), so
      // they trade a row and each writes one float4: t < 2 row g, else g + 8
      const bool lower = t < 2;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int nt = wn + WN * j;
        if (nt < nt2) {
          const int col = nt * 8 + 2 * t;
          const float bias0 = b2s[col], bias1 = b2s[col + 1];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const float2 ra =
                make_float2(relu(acc[mi][j][0] + bias0), relu(acc[mi][j][1] + bias1));
            const float2 rb =
                make_float2(relu(acc[mi][j][2] + bias0), relu(acc[mi][j][3] + bias1));
            const float2 send = lower ? rb : ra;
            const float2 got = make_float2(__shfl_xor_sync(0xffffffffu, send.x, 2),
                                           __shfl_xor_sync(0xffffffffu, send.y, 2));
            const int row = wm * 32 + mi * 16 + g + (lower ? 0 : 8);
            *reinterpret_cast<float4*>(H + row * p.ldh + nt * 8 + 4 * (t & 1)) =
                lower ? make_float4(ra.x, got.x, ra.y, got.y)
                      : make_float4(got.x, rb.x, got.y, rb.y);
          }
        }
      }
      __syncthreads();   // H is whole; Z is free
      if (r0 + p.rows < total) gather(r0 + p.rows);   // the next tile's rows, under layer 2
      PHASE(6)

      // layer 2 -> the running max
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;
      if (STREAM) {
        for (int i = 0; i < np2; ++i, ++q) {
          const float* Wp = acquire();
          const int k0 = i * kPanel;
          mma_panel<WN, false>(acc, H, p.ldh, k0, Wp, p.ldp, min(kPanel, p.c2p - k0), nt3,
                               wm, wn, g, t);
          __syncthreads();
        }
      } else {
        mma_panel<WN, true>(acc, H, p.ldh, 0, smem + p.o_w3, p.ld3, p.c2p, nt3, wm, wn, g, t);
      }
      PHASE(7)
      // the epilogue: bias, relu, the max over each centroid's rows. The rows
      // are in centroid order (centroids numbered up), so the warp's 32 rows
      // hold the centroids cfirst .. clast (in the mask mode some between
      // them may have none). For one or two of them a thread folds its 4
      // rows into a max for each, and 3 shuffles over g finish them; else a
      // segmented max over each 8-row group (lanes g = 0..7 of one t) with 3
      // shuffles a value. Padding rows have centroid -1.
      const int wr = wm * 32;
      const int cfirst = wr < rows ? codes[r0 + wr] >> kCodeBits : -1;
      const int clast = wr + 31 < rows ? codes[r0 + wr + 31] >> kCodeBits : -1;
      if (cfirst >= 0 && clast >= 0 && clast - cfirst <= 1) {
        const bool two = clast != cfirst;
        bool first[2][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            first[mi][h] = !two || codes[r0 + wr + mi * 16 + h * 8 + g] >> kCodeBits == cfirst;
        int* ma = mx + cfirst * p.c3;
        int* mb = mx + clast * p.c3;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int nt = wn + WN * j;
          if (nt < nt3) {
            const int col = nt * 8 + 2 * t;
            const float bias0 = b3s[col], bias1 = b3s[col + 1];
            float ya0 = 0.0f, ya1 = 0.0f, yb0 = 0.0f, yb1 = 0.0f;
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float y0 = relu(acc[mi][j][2 * h] + bias0);
                const float y1 = relu(acc[mi][j][2 * h + 1] + bias1);
                if (first[mi][h]) {
                  ya0 = fmaxf(ya0, y0);
                  ya1 = fmaxf(ya1, y1);
                } else {
                  yb0 = fmaxf(yb0, y0);
                  yb1 = fmaxf(yb1, y1);
                }
              }
            }
#pragma unroll
            for (int s = 4; s < 32; s *= 2) {
              ya0 = fmaxf(ya0, __shfl_xor_sync(0xffffffffu, ya0, s));
              ya1 = fmaxf(ya1, __shfl_xor_sync(0xffffffffu, ya1, s));
            }
            if (two) {
#pragma unroll
              for (int s = 4; s < 32; s *= 2) {
                yb0 = fmaxf(yb0, __shfl_xor_sync(0xffffffffu, yb0, s));
                yb1 = fmaxf(yb1, __shfl_xor_sync(0xffffffffu, yb1, s));
              }
            }
            if (g == 0) {
              if (col < p.c3) atomicMax(ma + col, __float_as_int(ya0));
              if (col + 1 < p.c3) atomicMax(ma + col + 1, __float_as_int(ya1));
              if (two && col < p.c3) atomicMax(mb + col, __float_as_int(yb0));
              if (two && col + 1 < p.c3) atomicMax(mb + col + 1, __float_as_int(yb1));
            }
          }
        }
      } else {
        int cid[2][2];
        bool ok[2][2][3], head[2][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = wr + mi * 16 + h * 8 + g;
            const int c = row < rows ? codes[r0 + row] >> kCodeBits : -1;
            cid[mi][h] = c;
#pragma unroll
            for (int s = 0; s < 3; ++s) {
              const int o = __shfl_down_sync(0xffffffffu, c, 4 << s);
              ok[mi][h][s] = g + (1 << s) < 8 && o == c;
            }
            const int prev = __shfl_up_sync(0xffffffffu, c, 4);
            head[mi][h] = c >= 0 && (g == 0 || prev != c);
          }
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int nt = wn + WN * j;
          if (nt < nt3) {
            const int col = nt * 8 + 2 * t;
            const float bias0 = b3s[col], bias1 = b3s[col + 1];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float y0 = relu(acc[mi][j][2 * h] + bias0);
                float y1 = relu(acc[mi][j][2 * h + 1] + bias1);
#pragma unroll
                for (int s = 0; s < 3; ++s) {
                  const float o0 = __shfl_down_sync(0xffffffffu, y0, 4 << s);
                  const float o1 = __shfl_down_sync(0xffffffffu, y1, 4 << s);
                  if (ok[mi][h][s]) {
                    y0 = fmaxf(y0, o0);
                    y1 = fmaxf(y1, o1);
                  }
                }
                if (head[mi][h]) {
                  int* m = mx + cid[mi][h] * p.c3;
                  if (col < p.c3) atomicMax(m + col, __float_as_int(y0));
                  if (col + 1 < p.c3) atomicMax(m + col + 1, __float_as_int(y1));
                }
              }
            }
          }
        }
      }
      PHASE(8)
    }
  };

  if constexpr (MASK) {
    // a pass for each list of rows until every mask row is read, the
    // running max carried across them
    for (;;) {
      const bool again = mask_walk();
      PHASE(1)
      const int total = pack();
      PHASE(2)
      chain(total);
      if (!again) break;
      __syncthreads();   // the chain is done with the list and the panel slots
      if (STREAM) issue(0);   // the next pass's first panel, under its walk
    }
  } else {
    ball_walk();
    PHASE(1)
    const int total = pack();
    PHASE(2)
    chain(total);
  }
  cp_async_wait<0>();   // a tile with no row leaves v (and a panel) in flight
  __syncthreads();
  float* o = out + (static_cast<size_t>(b) * S + s0) * p.c3;
  for (int i = tid; i < nc * p.c3; i += kThreads) {
    o[i] = MASK && !seen[i / p.c3] ? -1e30f : __int_as_float(mx[i]);
  }
  PHASE(9)
#ifdef MSG_BALL_PHASES
  if (tid == 0) atomicAdd(&g_phase[10], 1ull);
#endif
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// Plans and launches one mode (MASK: sel read, nsample 0; else xyz and
// new_xyz); the CUDA error of the launch.
template <bool MASK>
int launch(const float* xyz, const float* new_xyz, const float* sel, const float* u,
           const float* v, const float* W2, const float* b2, const float* W3,
           const float* b3, float* out, int B, int S, int N, int c1, int c2, int c3,
           float r2, int nsample, int tile, void* stream) {
  Plan p;
  if ((!MASK && nsample < 1) || !plan(c1, c2, c3, B, S, N, MASK ? 0 : nsample, tile, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // 16-byte copies and loads where every row they start lies on 16 bytes
  p.vec2 = c2 % 4 == 0 && aligned16(W2);
  p.vec3 = c3 % 4 == 0 && aligned16(W3);
  p.vecu = c1 % 4 == 0 && aligned16(u);
  p.vecv = c1 % 4 == 0 && aligned16(v);
  p.vecx = N % 4 == 0 && aligned16(MASK ? sel : xyz);
  const size_t smem = static_cast<size_t>(p.floats) * 4;
  auto kernel = p.wn == 8 ? (p.stream ? msg_ball_kernel<8, true, MASK>
                                      : msg_ball_kernel<8, false, MASK>)
                          : (p.stream ? msg_ball_kernel<4, true, MASK>
                                      : msg_ball_kernel<4, false, MASK>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + p.tile - 1) / p.tile, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz, new_xyz, sel, u, v, W2, b2, W3, b3, out, S, N, r2, nsample, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The layout a launch takes for widths (c1, c2, c3), B batch rows of S
// centroids, N points, nsample (0: the mask mode) and `tile` centroids a
// CTA (0: the kernel's choice, see plan): returns 1 and fills info with
// the centroids a CTA, whether the weights stream (1) or stay resident
// (0), the points of a walk chunk (0 in the mask mode), the dynamic shared
// memory in bytes, the rows of a row tile and the rows a centroid's
// segment holds (in the mask mode a pass's; more make another pass);
// returns 0 when nothing fits (widths over (128, 256, 256), tile over 32,
// N from 2^24, or the ball mode's lists too long for shared memory).
extern "C" int msg_ball_plan(int c1, int c2, int c3, int B, int S, int N, int nsample,
                             int tile, int* info) {
  Plan p;
  if (!plan(c1, c2, c3, B, S, N, nsample, tile, &p)) return 0;
  info[0] = p.tile;
  info[1] = p.stream;
  info[2] = p.chunk;
  info[3] = p.floats * 4;
  info[4] = p.rows;
  info[5] = p.kc;
  return 1;
}

// The ball mode. xyz [B, N, 3], new_xyz [B, S, 3], u [B, N, c1], v [B, S,
// c1], W2 [c1, c2], b2 [c2], W3 [c2, c3], b3 [c3], out [B, S, c3], all f32,
// contiguous, on the current device; r2 the squared radius in f32, nsample
// >= 1, tile as for msg_ball_plan. Returns the CUDA error of the launch (0 =
// success).
extern "C" int msg_ball_launch(const float* xyz, const float* new_xyz, const float* u,
                               const float* v, const float* W2, const float* b2,
                               const float* W3, const float* b3, float* out, int B, int S,
                               int N, int c1, int c2, int c3, float r2, int nsample,
                               int tile, void* stream) {
  return launch<false>(xyz, new_xyz, nullptr, u, v, W2, b2, W3, b3, out, B, S, N, c1, c2, c3,
                       r2, nsample, tile, stream);
}

// The mask mode. sel [B, S, N] f32 (a point is selected where > 0.5),
// the rest as for msg_ball_launch; a centroid that selects nothing gets
// -1e30. Returns the CUDA error of the launch (0 = success).
extern "C" int msg_ball_mask_launch(const float* sel, const float* u, const float* v,
                                    const float* W2, const float* b2, const float* W3,
                                    const float* b3, float* out, int B, int S, int N, int c1,
                                    int c2, int c3, int tile, void* stream) {
  return launch<true>(nullptr, nullptr, sel, u, v, W2, b2, W3, b3, out, B, S, N, c1, c2, c3,
                      0.0f, 0, tile, stream);
}

#ifdef MSG_BALL_PHASES
// Copies the phase counts into host[16] and zeroes them; the CUDA error.
extern "C" int msg_ball_phases(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));
  const unsigned long long zero[16] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
  return static_cast<int>(e);
}
#endif
