// Tensor-core and register-tiled helpers of K2's Hopper design
// (econ_filter.cu, `econ_tc_kernel`).  Included, never compiled alone.
//
// A block of kThreads = 256 threads (8 warps) owns one patch group at a
// time.  Every q x q matrix of the group is padded to kQ x kQ = 64 x 64
// and lives in registers as one f32 "fragment" per thread: warp w owns
// rows 16 (w >> 1) .. +16 and columns 32 (w & 1) .. +32, i.e. four
// m16n8 accumulator tiles of mma.sync, 16 floats per thread.  Element
// i = 4 j + e of a thread sits at
//   row r0 + 8 (e >> 1),  column c0 + 8 j + (e & 1),
//   r0 = 16 (w >> 1) + lane / 4,  c0 = 32 (w & 1) + 2 (lane % 4),
// which is the accumulator layout of mma.m16n8k16, so a product's result
// is the next matrix's state without a move.  Pad rows and columns (>= q)
// stay zero: the padded matrices are block-diagonal [M 0; 0 0], the
// identity is I_q (`diag`), and products keep the zero block.
//
// Operands go to shared memory once, rounded to bf16 when they are
// stored: `store_row` (X[r][k], the A side of a product) or `store_colT`
// (Y^T[n][k], the B side), row stride kLdb = 72 bf16 (144 B), so the
// eight 16-byte rows an ldmatrix phase reads fall on distinct banks.
// `mma_q` computes a whole padded q x q product into a fragment;
// `mma_rows` a row of m16n8 tiles of a larger product (the applications).
//
// `syrk` is the f32 product on CUDA cores (the covariance or Gram, and
// xn xc^T): S[r][c] = sum_k X[k][r] Y[k][c] from k-major copies (row k
// holds the 64 padded output indices at a stride of kLdk floats).  The
// depth is split over four slices of 64 threads; each thread keeps an 8x8
// block of outputs (rows 4 ty + i and 32 + 4 ty + i, columns likewise with
// tx) from four 16-byte loads per k: eight threads of a quarter-warp read
// one broadcast X vector and 128 contiguous bytes of Y, so shared memory
// delivers a value for every FMA issued.  The slices' sums meet in a fixed
// order, ((s0 + s2) + (s1 + s3)), through the operand buffers, and land in
// the fragment layout.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vnlb {
namespace tc {

constexpr int kThreads = 256;
constexpr int kQ = 64;              // padded q
constexpr int kLdb = 72;            // bf16 row stride of operand buffers
constexpr int kBuf = kQ * kLdb;     // bf16 elements of one operand buffer
constexpr int kNumBufs = 4;
constexpr int kLdk = kQ + 4;        // f32 row stride of k-major copies
constexpr int kLdp = kQ + 8;        // f32 row stride of the slices' sums
// dynamic shared memory of one block that still lets two blocks share an
// SM (228 KB per SM, 1 KB reserved per block, ~7.7 KB static per block)
constexpr int kSmemMax = 104 * 1024;

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Where a thread's fragment lies (see the top of the file).
struct Pos {
  int r0, c0;
  __device__ __forceinline__ Pos() {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    r0 = 16 * (w >> 1) + (lane >> 2);
    c0 = 32 * (w & 1) + 2 * (lane & 3);
  }
  __device__ __forceinline__ int row(int i) const {
    return r0 + 8 * ((i & 3) >> 1);
  }
  __device__ __forceinline__ int col(int i) const {
    return c0 + 8 * (i >> 2) + (i & 1);
  }
};

// 1 on the diagonal of the top-left q x q block, else 0
__device__ __forceinline__ float diag(const Pos& ps, int i, int q) {
  const int r = ps.row(i);
  return (r == ps.col(i) && r < q) ? 1.f : 0.f;
}

// S = sum_k X[k][:] (x) Y[k][:] over k < depth into the fragment layout
// (see the top of the file); X, Y k-major at a stride of kLdk.  `part`
// (2 x kQ x kLdp floats, the operand buffers) is free on entry and on
// exit; ends with a barrier.
__device__ __forceinline__ void syrk(float S[16], const float* X,
                                     const float* Y, int depth, float* part,
                                     const Pos& ps) {
  const int slice = threadIdx.x >> 6, ty = (threadIdx.x >> 3) & 7,
            tx = threadIdx.x & 7;
  const int kq = (depth + 3) / 4;
  const int k1 = min(depth, (slice + 1) * kq);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k = slice * kq; k < k1; ++k) {
    const float4 x0 = *reinterpret_cast<const float4*>(X + k * kLdk + 4 * ty);
    const float4 x1 =
        *reinterpret_cast<const float4*>(X + k * kLdk + 32 + 4 * ty);
    const float4 y0 = *reinterpret_cast<const float4*>(Y + k * kLdk + 4 * tx);
    const float4 y1 =
        *reinterpret_cast<const float4*>(Y + k * kLdk + 32 + 4 * tx);
    const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], yv[j], acc[i][j]);
  }
  // slices 2, 3 hand their sums to slices 0, 1, which hand theirs on
  auto at = [&](int sl, int i, int j) -> float* {
    return part + sl * kQ * kLdp + (4 * ty + (i & 3) + 32 * (i >> 2)) * kLdp +
           4 * tx + 32 * (j >> 2);
  };
  auto give = [&](int sl) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; j += 4)
        *reinterpret_cast<float4*>(at(sl, i, j)) = make_float4(
            acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
  };
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
  if (slice < 2) give(slice);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 16; i += 2) {
    const int off = ps.row(i) * kLdp + ps.col(i);
    const float2 a = *reinterpret_cast<const float2*>(part + off);
    const float2 b = *reinterpret_cast<const float2*>(part + kQ * kLdp + off);
    S[i] = a.x + b.x;
    S[i + 1] = a.y + b.y;
  }
  __syncthreads();
}

// buf[r][c] = bf16(f(i)) for the thread's elements (A-side layout)
template <class F>
__device__ __forceinline__ void store_row(__nv_bfloat16* buf, const Pos& ps,
                                          F f) {
#pragma unroll
  for (int i = 0; i < 16; i += 2) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(f(i), f(i + 1));
    *reinterpret_cast<__nv_bfloat162*>(buf + ps.row(i) * kLdb + ps.col(i)) =
        v;
  }
}

// buf[c][r] = bf16(f(i)) (B-side layout: the transpose, k contiguous)
template <class F>
__device__ __forceinline__ void store_colT(__nv_bfloat16* buf, const Pos& ps,
                                           F f) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    buf[ps.col(i) * kLdb + ps.row(i)] = __float2bfloat16_rn(f(i));
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
                                       const __nv_bfloat16* X, int m0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, X + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdb + k0 +
                 (lane >> 4) * 8);
}

// acc = X Y over the padded q x q block: X in row layout, Y in B-side
// layout, k over `ktiles` 16-wide steps (the rest is zero).
__device__ __forceinline__ void mma_q(float acc[16], const __nv_bfloat16* X,
                                      const __nv_bfloat16* Yt, int ktiles) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = 16 * (w >> 1), n0 = 32 * (w & 1);
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < ktiles; ++kt) {
    uint32_t a[4];
    load_a(a, X, m0, 16 * kt);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      uint32_t b[4];
      ldsm_x4(b, Yt + (n0 + 16 * jj + (lane & 7) + (lane >> 4) * 8) * kLdb +
                     16 * kt + ((lane >> 3) & 1) * 8);
      mma_bf16(acc + 8 * jj, a, b[0], b[1]);
      mma_bf16(acc + 8 * jj + 4, a, b[2], b[3]);
    }
  }
}

// c[j] = X[m0..m0+15][:] Y[:][n0 + 8 j .. +7] for j < cnt (<= 8) over
// `ktiles` 16-wide steps: X in row layout, Y in B-side layout (row stride
// kLdb both); one A fragment per step feeds cnt independent mma chains.
// c[j][e] lies at row m0 + lane / 4 + 8 (e >> 1), column
// n0 + 8 j + 2 (lane % 4) + (e & 1).
__device__ __forceinline__ void mma_rows(float c[8][4],
                                         const __nv_bfloat16* X, int m0,
                                         const __nv_bfloat16* Yt, int n0,
                                         int cnt, int ktiles) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
  for (int kt = 0; kt < ktiles; ++kt) {
    uint32_t a[4];
    load_a(a, X, m0, 16 * kt);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < cnt) {
        uint32_t b[2];
        ldsm_x2(b, Yt + (n0 + 8 * j + (lane & 7)) * kLdb + 16 * kt +
                       ((lane >> 3) & 1) * 8);
        mma_bf16(c[j], a, b[0], b[1]);
      }
    }
  }
}

}  // namespace tc
}  // namespace vnlb
