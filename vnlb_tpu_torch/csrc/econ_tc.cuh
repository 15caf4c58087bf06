// Tensor-core and register-tiled helpers of the filter kernels' Hopper
// designs: K2 (econ_filter.cu, `econ_tc_kernel` at width 64 and
// `econ_tcw_kernel` at width 128) and K5 (poly_filter.cu,
// `poly_tc_kernel<W>`).  Included, never compiled alone.
//
// The padded width W is a compile-time parameter: every q x q matrix of a
// group is padded to W x W with a zero block (the padded matrices are
// block-diagonal [M 0; 0 0], the identity is I_q (`diag`), and products
// keep the zero block).  Two widths exist (`Width`): 64, a block of 256
// threads (8 warps), two blocks per SM; 128, a block of 512 threads (16
// warps), one block per SM.  128 and not 112 for the wide width: 16 warps
// tile 128 x 128 as a regular 4 x 4 grid of 32 x 32 warp tiles (each A
// fragment feeds four mma, each B fragment two), it takes every p <= 128
// (the 16 x 128 groups of pt=2, ps=8 included), and its padding costs
// (128/98)^2 x 112/98 = 1.95x at p = 98 instead of 1.5x, paid in tensor-
// core work only, which is not what bounds the chains (their dependent
// products and barriers are).
//
// An MR x NC matrix lives in registers as one f32 "fragment" per thread
// (`Frag<MR, NC, NT>`): the NT / 32 warps form a grid of NC / 32 columns,
// warp w owning rows RW (w / (NC / 32)) .. +RW and columns 32 (w % (NC /
// 32)) .. +32, i.e. MT = RW / 16 rows of four m16n8 accumulator tiles of
// mma.sync, 16 MT floats per thread.  Element i = 16 mt + 4 j + e of a
// thread sits at
//   row r0 + 16 mt + 8 (e >> 1),  column c0 + 8 j + (e & 1),
//   r0 = RW (w / (NC / 32)) + lane / 4,  c0 = 32 (w % (NC / 32)) + 2 (lane % 4),
// which is the accumulator layout of mma.m16n8k16, so a product's result
// is the next matrix's state without a move.  Width 64: Frag<64, 64, 256>
// (16 floats).  Width 128: Frag<128, 128, 512> (32 floats) and, for K x p
// states with K <= 64, Frag<64, 128, 512> (16 floats).
//
// Operands go to shared memory once, rounded to bf16 when they are
// stored: `store_row` (X[r][k], the A side of a product) or `store_colT`
// (Y^T[n][k], the B side), at a row stride of W + 8 bf16 (an odd multiple
// of 16 bytes), so the eight 16-byte rows an ldmatrix phase reads fall on
// distinct banks.  `mma_acc` adds a padded product into a fragment;
// `mma_rows_acc` computes a row of m16n8 tiles of a larger product (the
// applications), `mma_rows3` the same summed over three A-side buffers
// that share their B fragments (K5's xn in three bf16 parts).
// `load_padded` brings a patch block from device memory into a padded
// shared layout, `frag_lub` reduces a fragment to the spectral bound in a
// fixed order, and `occupancy_grid` sizes a launch to one block per
// resident slot.
//
// `syrk` is the f32 product on CUDA cores (the covariance or Gram, xn xc^T,
// and K5's xn W): S[r][c] = sum_k X[k][r] Y[k][c] from k-major copies (row
// k holds the MR padded output rows of X, the NC columns of Y).  The depth
// is split over NS slices of (MR / 8) (NC / 8) threads; each thread keeps
// an 8x8 block of outputs (rows 4 ty + i and MR/2 + 4 ty + i, columns
// likewise with tx) from four 16-byte loads per k, so shared memory
// delivers a value for every FMA issued.  The slices' sums meet in a fixed
// order, ((s0 + s2) + (s1 + s3)) for four slices, (s0 + s1) for two,
// through a scratch area, and land in the fragment layout: a repeat run is
// bitwise equal.
//
// The names at the end of the file (kQ, Pos, syrk, mma_q, ...) are width
// 64 as K2's tensor-core kernel has used them since it was written; the
// generic templates at width 64 perform the same operations in the same
// order, so that kernel's output is unchanged.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "group_mm.cuh"

namespace vnlb {
namespace tc {

// threads of a block and blocks per SM at a padded width
template <int W>
struct Width;
template <>
struct Width<64> {
  static constexpr int kThreads = 256, kBlocks = 2;
};
template <>
struct Width<128> {
  static constexpr int kThreads = 512, kBlocks = 1;
};

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Where a thread's fragment of an MR x NC matrix lies (see the top of the
// file).
template <int MR, int NC, int NT>
struct Frag {
  static constexpr int kWc = NC / 32;           // warp columns
  static constexpr int kWr = NT / 32 / kWc;     // warp rows
  static constexpr int kRw = MR / kWr;          // rows of a warp tile
  static constexpr int kMt = kRw / 16;          // m16 tiles of a warp
  static constexpr int N = 16 * kMt;            // floats per thread
  static_assert(kRw % 16 == 0 && kMt >= 1, "fragment geometry");
  int r0, c0;
  __device__ __forceinline__ Frag() {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    r0 = kRw * (w / kWc) + (lane >> 2);
    c0 = 32 * (w % kWc) + 2 * (lane & 3);
  }
  __device__ __forceinline__ int row(int i) const {
    return r0 + 16 * (i >> 4) + 8 * ((i & 3) >> 1);
  }
  __device__ __forceinline__ int col(int i) const {
    return c0 + 8 * ((i >> 2) & 3) + (i & 1);
  }
  // first row / column of the thread's warp tile
  static __device__ __forceinline__ int m0() {
    return kRw * ((threadIdx.x >> 5) / kWc);
  }
  static __device__ __forceinline__ int n0() {
    return 32 * ((threadIdx.x >> 5) % kWc);
  }
};

// 1 on the diagonal of the top-left q x q block, else 0
template <class F>
__device__ __forceinline__ float diag(const F& ps, int i, int q) {
  const int r = ps.row(i);
  return (r == ps.col(i) && r < q) ? 1.f : 0.f;
}

// S = sum_k X[k][:] (x) Y[k][:] over k < depth into the fragment layout
// (see the top of the file); X at a row stride of ldx floats (MR outputs
// per row), Y at ldy (NC).  `part` (2 x MR x (NC + 8) floats) is free on
// entry and on exit; ends with a barrier.
template <int MR, int NC, int NT>
__device__ __forceinline__ void syrk(float* S, const float* X, int ldx,
                                     const float* Y, int ldy, int depth,
                                     float* part,
                                     const Frag<MR, NC, NT>& ps) {
  constexpr int TY = MR / 8, TX = NC / 8, NS = NT / (TX * TY);
  constexpr int kLdp = NC + 8;
  static_assert(NS == 2 || NS == 4, "depth slices");
  const int slice = threadIdx.x / (TX * TY), ty = (threadIdx.x / TX) % TY,
            tx = threadIdx.x % TX;
  const int kq = (depth + NS - 1) / NS;
  const int k1 = min(depth, (slice + 1) * kq);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k = slice * kq; k < k1; ++k) {
    const float4 x0 = *reinterpret_cast<const float4*>(X + k * ldx + 4 * ty);
    const float4 x1 =
        *reinterpret_cast<const float4*>(X + k * ldx + MR / 2 + 4 * ty);
    const float4 y0 = *reinterpret_cast<const float4*>(Y + k * ldy + 4 * tx);
    const float4 y1 =
        *reinterpret_cast<const float4*>(Y + k * ldy + NC / 2 + 4 * tx);
    const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], yv[j], acc[i][j]);
  }
  auto at = [&](int sl, int i, int j) -> float* {
    return part + sl * MR * kLdp +
           (4 * ty + (i & 3) + (MR / 2) * (i >> 2)) * kLdp + 4 * tx +
           (NC / 2) * (j >> 2);
  };
  auto give = [&](int sl) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; j += 4)
        *reinterpret_cast<float4*>(at(sl, i, j)) = make_float4(
            acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
  };
  if constexpr (NS == 4) {
    // slices 2, 3 hand their sums to slices 0, 1, which hand theirs on
    if (slice >= 2) give(slice - 2);
    __syncthreads();
    if (slice < 2) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; j += 4) {
          const float4 v = *reinterpret_cast<const float4*>(at(slice, i, j));
          acc[i][j] += v.x;
          acc[i][j + 1] += v.y;
          acc[i][j + 2] += v.z;
          acc[i][j + 3] += v.w;
        }
    }
    __syncthreads();
  }
  if (slice < 2) give(slice);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < Frag<MR, NC, NT>::N; i += 2) {
    const int off = ps.row(i) * kLdp + ps.col(i);
    const float2 a = *reinterpret_cast<const float2*>(part + off);
    const float2 b = *reinterpret_cast<const float2*>(part + MR * kLdp + off);
    S[i] = a.x + b.x;
    S[i + 1] = a.y + b.y;
  }
  __syncthreads();
}

// buf[r][c] = bf16(f(i)) for the thread's elements (A-side layout)
template <int MR, int NC, int NT, class F>
__device__ __forceinline__ void store_row(__nv_bfloat16* buf, int ldb,
                                          const Frag<MR, NC, NT>& ps, F f) {
#pragma unroll
  for (int i = 0; i < Frag<MR, NC, NT>::N; i += 2) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(f(i), f(i + 1));
    *reinterpret_cast<__nv_bfloat162*>(buf + ps.row(i) * ldb + ps.col(i)) =
        v;
  }
}

// buf[c][r] = bf16(f(i)) (B-side layout: the transpose, k contiguous)
template <int MR, int NC, int NT, class F>
__device__ __forceinline__ void store_colT(__nv_bfloat16* buf, int ldb,
                                           const Frag<MR, NC, NT>& ps, F f) {
#pragma unroll
  for (int i = 0; i < Frag<MR, NC, NT>::N; ++i)
    buf[ps.col(i) * ldb + ps.row(i)] = __float2bfloat16_rn(f(i));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t r[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a (16x16, bf16) b (16x8, bf16), f32 accumulation
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows m0..m0+15, columns k0..k0+15 of a row-layout buffer
__device__ __forceinline__ void load_a(uint32_t a[4],
                                       const __nv_bfloat16* X, int ldb,
                                       int m0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, X + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb + k0 +
                 (lane >> 4) * 8);
}

// acc += X Y over the padded MR x NC block: X in row layout, Y in B-side
// layout (row stride ldb both), k over `ktiles` 16-wide steps (the rest is
// zero).
template <int MR, int NC, int NT>
__device__ __forceinline__ void mma_acc(float* acc, const __nv_bfloat16* X,
                                        const __nv_bfloat16* Yt, int ldb,
                                        int ktiles) {
  using Fr = Frag<MR, NC, NT>;
  const int lane = threadIdx.x & 31;
  const int m0 = Fr::m0(), n0 = Fr::n0();
  for (int kt = 0; kt < ktiles; ++kt) {
    uint32_t a[Fr::kMt][4];
#pragma unroll
    for (int mt = 0; mt < Fr::kMt; ++mt)
      load_a(a[mt], X, ldb, m0 + 16 * mt, 16 * kt);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      uint32_t b[4];
      ldsm_x4(b, Yt + (n0 + 16 * jj + (lane & 7) + (lane >> 4) * 8) * ldb +
                     16 * kt + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < Fr::kMt; ++mt) {
        mma_bf16(acc + 16 * mt + 8 * jj, a[mt], b[0], b[1]);
        mma_bf16(acc + 16 * mt + 8 * jj + 4, a[mt], b[2], b[3]);
      }
    }
  }
}

// acc = X Y (see mma_acc)
template <int MR, int NC, int NT>
__device__ __forceinline__ void mma_frag(float* acc, const __nv_bfloat16* X,
                                         const __nv_bfloat16* Yt, int ldb,
                                         int ktiles) {
#pragma unroll
  for (int i = 0; i < Frag<MR, NC, NT>::N; ++i) acc[i] = 0.f;
  mma_acc<MR, NC, NT>(acc, X, Yt, ldb, ktiles);
}

// c[j] += X[m0..m0+15][:] Y[:][n0 + 8 j .. +7] for j < cnt (<= 8) over
// `ktiles` 16-wide steps: X in row layout, Y in B-side layout (row stride
// ldb both); one A fragment per step feeds cnt independent mma chains.
// c[j][e] lies at row m0 + lane / 4 + 8 (e >> 1), column
// n0 + 8 j + 2 (lane % 4) + (e & 1).
__device__ __forceinline__ void mma_rows_acc(float c[8][4],
                                             const __nv_bfloat16* X, int m0,
                                             const __nv_bfloat16* Yt, int n0,
                                             int ldb, int cnt, int ktiles) {
  const int lane = threadIdx.x & 31;
  for (int kt = 0; kt < ktiles; ++kt) {
    uint32_t a[4];
    load_a(a, X, ldb, m0, 16 * kt);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < cnt) {
        uint32_t b[2];
        ldsm_x2(b, Yt + (n0 + 8 * j + (lane & 7)) * ldb + 16 * kt +
                       ((lane >> 3) & 1) * 8);
        mma_bf16(c[j], a, b[0], b[1]);
      }
    }
  }
}

// c[j] += sum_t X_t[m0..m0+15][:] Y[:][n0 + 8 j .. +7] over the three
// row-layout buffers X_t = X + t * xstride (mma_rows_acc's layout): each k
// step loads its B fragments once for the three, and every fragment
// before its first mma, so a step waits for shared memory once
__device__ __forceinline__ void mma_rows3(float c[8][4],
                                          const __nv_bfloat16* X,
                                          int xstride, int m0,
                                          const __nv_bfloat16* Yt, int n0,
                                          int ldb, int cnt, int ktiles) {
  const int lane = threadIdx.x & 31;
  for (int kt = 0; kt < ktiles; ++kt) {
    uint32_t a[3][4], b[8][2];
#pragma unroll
    for (int t = 0; t < 3; ++t)
      load_a(a[t], X + t * xstride, ldb, m0, 16 * kt);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < cnt)
        ldsm_x2(b[j], Yt + (n0 + 8 * j + (lane & 7)) * ldb + 16 * kt +
                          ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < cnt) mma_bf16(c[j], a[t], b[j][0], b[j][1]);
  }
}

// lub = max(min(trace, max row |sum|), floor) * 1.02 of the W x W
// fragment A (a padded q x q matrix: pad rows and columns zero) into *dst;
// rowpart (W / 32 x W floats) and diagv (W floats) are scratch.  Ends with
// a barrier.  The row sums meet in a fixed order: a repeat run is bitwise
// equal.
template <int W, int NT>
__device__ __forceinline__ void frag_lub(const float* A,
                                         const Frag<W, W, NT>& ps,
                                         float* rowpart, float* diagv,
                                         float floor_, float* dst) {
  using Fr = Frag<W, W, NT>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < Fr::kMt; ++mt) {
    float ra = 0.f, rb = 0.f;
#pragma unroll
    for (int i = 16 * mt; i < 16 * mt + 16; ++i) {
      if (i & 2)
        rb += fabsf(A[i]);
      else
        ra += fabsf(A[i]);
      if (ps.row(i) == ps.col(i)) diagv[ps.row(i)] = A[i];
    }
    ra += __shfl_xor_sync(0xffffffffu, ra, 1);
    rb += __shfl_xor_sync(0xffffffffu, rb, 1);
    ra += __shfl_xor_sync(0xffffffffu, ra, 2);
    rb += __shfl_xor_sync(0xffffffffu, rb, 2);
    if ((lane & 3) == 0) {
      rowpart[(warp % Fr::kWc) * W + ps.r0 + 16 * mt] = ra;
      rowpart[(warp % Fr::kWc) * W + ps.r0 + 16 * mt + 8] = rb;
    }
  }
  __syncthreads();
  if (warp == 0) {
    float tr = 0.f, rs = 0.f;
#pragma unroll
    for (int t = 0; t < W / 32; ++t) {
      const int r = lane + 32 * t;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < Fr::kWc; ++c) s += rowpart[c * W + r];
      tr += diagv[r];
      rs = fmaxf(rs, s);
    }
    tr = warp_sum(tr);
    rs = warp_max(rs);
    if (lane == 0) *dst = fmaxf(fminf(tr, rs), floor_) * 1.02f;
  }
  __syncthreads();
}

// put(r, c, v) for r < rows, c < W: v = src[r * p + c] for r < rows_v and
// c < p, else 0 (the pad rows and columns), kU loads of each thread in
// flight; neighbouring threads read neighbouring addresses.
template <int W, int NT, class Put>
__device__ __forceinline__ void load_padded(const float* __restrict__ src,
                                            int rows, int rows_v, int p,
                                            Put put) {
  constexpr int kU = 16;
  const int n = rows * W;
  for (int e0 = threadIdx.x; e0 < n; e0 += kU * NT) {
    float v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * NT, r = e / W, c = e % W;
      v[u] = (e < n && r < rows_v && c < p) ? __ldg(src + r * p + c) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * NT;
      if (e < n) put(e / W, e % W, v[u]);
    }
  }
}

// out[r][c] for the tile row of an application (see mma_rows_acc), rows
// < K and columns < p: val(r, c, acc)
template <class F>
__device__ __forceinline__ void apply_rows(float* o, int K, int p, int m0,
                                           int n0, int cnt,
                                           const float c[8][4], F val) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j >= cnt) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + (lane >> 2) + 8 * (e >> 1);
      const int col = n0 + 8 * j + 2 * (lane & 3) + (e & 1);
      if (r < K && col < p) o[r * p + col] = val(r, col, c[j][e]);
    }
  }
}

// Units of an application over the warps: mt 16-row tiles x ns runs of
// nh <= 8 column tiles of 8 (nt of them).
struct Units {
  int ns, nh;
  __device__ __forceinline__ Units(int mt, int nt, int warps) {
    ns = max((nt + 7) / 8, mt >= warps ? 1 : warps / mt);
    nh = (nt + ns - 1) / ns;
  }
};

// Blocks of a launch of `kernel` (threads, smem bytes of dynamic shared
// memory): one per resident slot, at most G; the blocks an SM keeps in
// *per_sm when given.  Returns a cudaError_t.
inline int occupancy_grid(const void* kernel, int threads, int smem, int G,
                          int* grid, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, occ = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  const long long slots = (long long)sms * occ;
  *grid = (int)(slots < G ? slots : G);
  if (per_sm != nullptr) *per_sm = occ;
  return 0;
}

// ---- width 64 under the names K2's tensor-core kernel uses ----

constexpr int kThreads = Width<64>::kThreads;
constexpr int kQ = 64;              // padded q
constexpr int kLdb = kQ + 8;        // bf16 row stride of operand buffers
constexpr int kBuf = kQ * kLdb;     // bf16 elements of one operand buffer
constexpr int kNumBufs = 4;
constexpr int kLdk = kQ + 4;        // f32 row stride of k-major copies
constexpr int kLdp = kQ + 8;        // f32 row stride of the slices' sums
// dynamic shared memory of one block that still lets two blocks share an
// SM (228 KB per SM, 1 KB reserved per block, ~7.7 KB static per block)
constexpr int kSmemMax = 104 * 1024;

using Pos = Frag<kQ, kQ, kThreads>;

__device__ __forceinline__ void syrk(float S[16], const float* X,
                                     const float* Y, int depth, float* part,
                                     const Pos& ps) {
  syrk<kQ, kQ, kThreads>(S, X, kLdk, Y, kLdk, depth, part, ps);
}

template <class F>
__device__ __forceinline__ void store_row(__nv_bfloat16* buf, const Pos& ps,
                                          F f) {
  store_row(buf, kLdb, ps, f);
}

template <class F>
__device__ __forceinline__ void store_colT(__nv_bfloat16* buf, const Pos& ps,
                                           F f) {
  store_colT(buf, kLdb, ps, f);
}

__device__ __forceinline__ void mma_q(float acc[16], const __nv_bfloat16* X,
                                      const __nv_bfloat16* Yt, int ktiles) {
  mma_frag<kQ, kQ, kThreads>(acc, X, Yt, kLdb, ktiles);
}

__device__ __forceinline__ void mma_rows(float c[8][4],
                                         const __nv_bfloat16* X, int m0,
                                         const __nv_bfloat16* Yt, int n0,
                                         int cnt, int ktiles) {
#pragma unroll
  for (int j = 0; j < 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
  mma_rows_acc(c, X, m0, Yt, n0, kLdb, cnt, ktiles);
}

}  // namespace tc
}  // namespace vnlb
