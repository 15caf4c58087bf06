// K5's batched tensor-core design ("tcb"): the left route (K < p) of the
// two-factor polynomial filter for the groups the one-block tensor-core
// design (poly_filter.cu `poly_tc_kernel`) does not take: the joint groups
// of couple_channels ((100, 147), (60, 294), (100, 294), (60, 147)), left
// routes with K > 64, and p > 128 (ops/poly_filter.py `design`).
//
// Replaces the Pallas kernel vnlb_tpu/ops/pallas_poly.py:50
// (`_poly_kernel`, launched at pallas_poly.py:153 by `poly_filter_pallas`
// :125) on those shapes; the function is vnlb_tpu/ops/polyspec.py
// `poly_filter` (:96-190), with its cast points (`st`: bf16 storage
// rounding under poly_bf16), as poly_filter.cu's header sets out.
//
// What bounds it on the H100.  A (60, 294) group does 15 dependent p x p
// x p products in the gate and 8 K x p x p products in the recurrence,
// ~0.8 GFLOP, and its state is five to seven p x p matrices (1.3 MB at p
// = 294 in bf16), beyond one SM's 227 KB: the chain cannot stay on one SM,
// as the other designs keep it.  Every product goes through L2 and a device
// workspace, one launch over a sub-batch of groups.  What bounds it
// (scripts/k5_tcb_bottleneck.py): the tensor cores' rate under mma.sync
// (~250 multiply-adds a cycle an SM in either mode), copies that overlap
// it only in part, and the recurrence's f32 state through the workspace.
//
// The design.  Each product of a sub-batch is one launch of `tcb_mm`, one
// 128-thread block per (group, 64 x 64 output tile), four warps of 32 x
// 32, a group's tiles consecutive so that its operands come from HBM once
// and then from L2.  p is padded to pp = round_up(p, 16) and K to
// round_up(K, 16) (zero pad blocks, exact for this function:
// vnlb_tpu/ops/pallas_poly.py:22-27).  A and B reach shared memory in
// k-chunks through a ring of three stages by 16-byte cp.async (the copies
// of the next two chunks in flight while one is multiplied); B is stored
// row-major and read transposed by ldmatrix.trans, so every matrix exists
// once.  Under poly_bf16 (`Bf16Mode`, chunks of 64) operands are bf16 and
// each 16-deep step is one mma.sync m16n8k16 with f32 accumulation;
// without it (`Tf32Mode`, chunks of 32) they are f32 and each 8-deep step
// is three TF32 mma of operands split in registers (econ_tc.cuh `split`,
// `mma_term`).  In split TF32 every gate product is a polynomial in the
// symmetric S (S^2, S^3, S^5, S st(S S)), so only the tiles on and above the
// diagonal are computed and each value is stored at (i, j) and (j, i): 15 of
// 25 tiles at p = 294, 6 of 9 at p = 147; the mirrored S^2 S is S S^2, which
// differs from the plain version's product by f32 rounding order only.  Under
// poly_bf16 the gate computes every tile: st(S^2) does not commute with S,
// so a mirrored S^3 would be the other-order product at st's rounding
// level, not the plain version's (rms / scale 5.0e-3 against 2.9e-3 at (60,
// 294) on an H100, scripts/k5_tcb_probe.py).  The elementwise work of each
// step is its product's epilogue (`Ep`): st(S S); S^3 in f32 and rounded;
// st(a S + b S^3 + c S^5) in place of S; st(1.5 S - 0.5 S st(S S)) into the
// other S buffer; z_0 = xn W = (xn S + xn) / 2, xn in three bf16 parts (hi
// + mid + lo = xn exactly) as one product of depth 3 pp; z_1 = st(z_0) Ah
// and z_j = 2 st(z_{j-1}) Ah - z_{j-2}, each adding coef_j z_j into a
// running sum in the workspace, the last into the (G, K, p) output.  Two
// kernels before the gate, one block per (group, 64 rows): `tcb_cov` forms
// C = xc^T xc / K in f32 on CUDA cores with each row's |sum| and diagonal,
// `tcb_init` folds them into lub in a fixed order and writes the Chebyshev
// coefficients, S_0, Ah and xn's parts.  Every sum has a fixed order: a
// repeat launch is bitwise equal.  The workspace (`TcbPlan`, mirrored by
// ops/poly_filter.py `tcb_plan`) holds one sub-batch of at most kWsBytes;
// the wrapper allocates it; the kernels allocate nothing.

#include <type_traits>

#include "econ_tc.cuh"
#include "group_mm.cuh"

namespace {

namespace tc = vnlb::tc;
using bf16 = __nv_bfloat16;

constexpr int kProThreads = 256;
constexpr int kMaxNodes = 128, kMaxCoef = 64;  // poly_filter.cu's tables
constexpr int kMaxP = 512;                     // two columns a thread
constexpr int kProSmemMax = 200 * 1024;        // xc and a strip of C
// a sub-batch's workspace (ops/poly_filter.py TCB_WS_BYTES)
constexpr long long kWsBytes = 512LL << 20;

// A block's output tile: 64 x 64 over four warps of 32 x 32 (MT m16 rows,
// NT n8 columns each), k-chunks of BK through NS shared-memory stages.
// Shared rows of A: BK + PAD elements (bf16 + 8, f32 + 4: the rows an
// ldmatrix phase reads on distinct banks); of B: 64 + 8 (ldmatrix.trans,
// or the f32 scalar loads of row t, column g, on distinct banks).
template <int BK_, int NS_, int PAD_, int MINB_>
struct Tile {
  static constexpr int BM = 64, BN = 64, WM = 2, WN = 2, BK = BK_;
  static constexpr int NS = NS_, kPad = PAD_;
  static constexpr int kThreads = 32 * WM * WN, kMinBlocks = MINB_;
  static constexpr int MT = BM / WM / 16, NT = BN / WN / 8;
  static constexpr int kBld = BN + 8;
};
constexpr int kTile = 64;

// Operand modes, each with its tile: chunks of 64 with bf16 operands,
// of 32 in split TF32 (deeper chunks were faster in bf16 and slower in
// split TF32, whose stages of 64 leave too little in flight)
struct Bf16Mode {
  using T = bf16;
  static constexpr bool kF32 = false;
  using Tl = Tile<64, 3, 8, 3>;
};
struct Tf32Mode {
  using T = float;
  static constexpr bool kF32 = true;
  using Tl = Tile<32, 3, 4, 4>;
};

template <class M>
__host__ __device__ constexpr int mm_smem() {
  using Tl = typename M::Tl;
  return Tl::NS * (Tl::BM * (Tl::BK + Tl::kPad) + Tl::BK * Tl::kBld) *
         (int)sizeof(typename M::T);
}

__host__ __device__ inline long long align256(long long x) {
  return (x + 255) / 256 * 256;
}

// One group's share of the workspace (byte offsets into it; each buffer
// 256-byte aligned), the padded sizes and the sub-batch.  pp == 0: the
// design does not take (K, p).  ops/poly_filter.py `tcb_plan` mirrors it.
struct TcbPlan {
  int pp, kp, tiles, ztiles, batch;
  long long group_bytes;
  long long ah, sa, sb, s2, s3b, s3f, coef, rsum, diag, xnp, zf0, zf1, zs,
      zb0, zb1;
};

// the prologue's dynamic shared memory: xc at rows of round_up(p, 4)
// floats (a strip's 16 rows load as four float4) and a strip of C
inline long long pro_smem(int K, int p) {
  return ((long long)K * tc::round_up(p, 4) + 16LL * tc::round_up(p, 16)) *
         4;
}

inline bool tcb_takes(int K, int p) {
  return K >= 1 && K < p && p <= kMaxP && pro_smem(K, p) <= kProSmemMax;
}

inline TcbPlan tcb_plan(int G, int K, int p, bool f32) {
  TcbPlan L = {};
  if (!tcb_takes(K, p)) return L;
  L.pp = tc::round_up(p, 16);
  L.kp = tc::round_up(K, 16);
  const long long e = f32 ? 4 : 2, P = (long long)L.pp * L.pp,
                  Z = (long long)L.kp * L.pp;
  long long off = 0;
  auto take = [&](long long bytes) {
    const long long o = off;
    off += align256(bytes);
    return o;
  };
  L.ah = take(P * e);
  L.sa = take(P * e);
  L.sb = take(P * e);
  L.s2 = take(P * e);
  L.s3b = f32 ? -1 : take(P * e);
  L.s3f = take(P * 4);
  if (f32) L.s3b = L.s3f;
  L.coef = take(kMaxCoef * 4);
  L.rsum = take(L.pp * 4);
  L.diag = take(L.pp * 4);
  L.xnp = take((f32 ? 1 : 3) * Z * e);
  L.zf0 = take(Z * 4);
  L.zf1 = take(Z * 4);
  L.zs = take(Z * 4);
  L.zb0 = f32 ? L.zf0 : take(Z * e);
  L.zb1 = f32 ? L.zf1 : take(Z * e);
  L.group_bytes = off;
  // a p x p product of the gate: every tile under bf16, the tiles on and
  // above the diagonal in split TF32 (a symmetric product)
  const int tn = (L.pp + kTile - 1) / kTile;
  L.tiles = f32 ? tn * (tn + 1) / 2 : tn * tn;
  L.ztiles = tn * ((L.kp + kTile - 1) / kTile);
  // as many groups as kWsBytes holds, then even sub-batches
  long long cap = kWsBytes / L.group_bytes;
  cap = cap < 1 ? 1 : cap;
  const long long n = G < 1 ? 1 : (G + cap - 1) / cap;
  L.batch = (int)((G < 1 ? 1 : G + n - 1) / n);
  return L;
}

template <class T>
__device__ __forceinline__ void store2(T* dst, float a, float b) {
  if constexpr (std::is_same<T, float>::value)
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
  else
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

template <class T>
__device__ __forceinline__ float2 load2(const T* src) {
  if constexpr (std::is_same<T, float>::value)
    return *reinterpret_cast<const float2*>(src);
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
}

template <class T>
__device__ __forceinline__ T to_t(float v) {
  if constexpr (std::is_same<T, float>::value)
    return v;
  else
    return __float2bfloat16_rn(v);
}

// ---- the prologue: C, lub, the coefficients, S_0, Ah, xn's parts ----
//
// Two kernels, one block per (group, strip of kStrip rows): `tcb_cov`
// forms the strip's rows of C = xc^T xc / K in f32 on CUDA cores (xc in
// shared memory, 16 rows at a time, columns j0 and, for p > 256, j1 a
// thread) with each row's |sum| and diagonal; `tcb_init` folds those into
// lub in a fixed order (every block of a group alike), the first strip's
// block forms the Chebyshev coefficients, and each block writes its rows
// of S_0, Ah and xn's parts.

constexpr int kStrip = 64;

template <class M>
__global__ void __launch_bounds__(kProThreads)
tcb_cov(const float* __restrict__ xc, int K, int p, int strips, TcbPlan L,
        unsigned char* ws) {
  extern __shared__ __align__(16) float psm[];
  const int b = blockIdx.x / strips,
            s0 = (blockIdx.x - b * strips) * kStrip;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pp = L.pp, ldx = tc::round_up(p, 4);
  if (s0 >= p) return;
  float* X = psm;             // xc, K rows of ldx (zero past p)
  float* cs = psm + K * ldx;  // 16 rows of C, pp columns
  unsigned char* gw = ws + (size_t)b * L.group_bytes;
  float* C = reinterpret_cast<float*>(gw + L.s3f);
  float* rsum = reinterpret_cast<float*>(gw + L.rsum);
  float* diag = reinterpret_cast<float*>(gw + L.diag);
  const size_t base = (size_t)b * K * p;
  for (int k = warp; k < K; k += kProThreads / 32)
    for (int c = lane; c < ldx; c += 32)
      X[k * ldx + c] = c < p ? __ldg(xc + base + k * p + c) : 0.f;
  __syncthreads();

  const float invk = 1.f / (float)K;
  const int j0 = tid, j1 = tid + kProThreads;
  const int jj0 = min(j0, ldx - 1), jj1 = min(j1, ldx - 1);
  // every thread takes column j1 too when p > 256; else threads past p
  // only store the pad
  const bool two = p > kProThreads;
  for (int i0 = s0; i0 < min(p, s0 + kStrip); i0 += 16) {
    float c0[16], c1[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) c0[r] = c1[r] = 0.f;
    if (two || j0 < p) {
      for (int k = 0; k < K; ++k) {
        const float* xr = X + k * ldx;
        float xv[16];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // rows past the buffer read the first quad (never stored)
          const int c = i0 + 4 * q < ldx ? i0 + 4 * q : 0;
          const float4 v = *reinterpret_cast<const float4*>(xr + c);
          xv[4 * q] = v.x;
          xv[4 * q + 1] = v.y;
          xv[4 * q + 2] = v.z;
          xv[4 * q + 3] = v.w;
        }
        const float y0 = xr[jj0];
#pragma unroll
        for (int r = 0; r < 16; ++r) c0[r] = fmaf(xv[r], y0, c0[r]);
        if (two) {
          const float y1 = xr[jj1];
#pragma unroll
          for (int r = 0; r < 16; ++r) c1[r] = fmaf(xv[r], y1, c1[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int i = i0 + r;
      if (i >= p) break;
      if (j0 < pp) {
        const float v = j0 < p ? c0[r] * invk : 0.f;
        cs[r * pp + j0] = v;
        C[(size_t)i * pp + j0] = v;
      }
      if (j1 < pp) {
        const float v = j1 < p ? c1[r] * invk : 0.f;
        cs[r * pp + j1] = v;
        C[(size_t)i * pp + j1] = v;
      }
    }
    __syncthreads();
    // row |sums| and the diagonal, two rows a warp
    for (int r = 2 * warp; r < 2 * warp + 2; ++r) {
      if (i0 + r >= p) break;
      float sm = 0.f;
      for (int j = lane; j < p; j += 32) sm += fabsf(cs[r * pp + j]);
      sm = vnlb::warp_sum(sm);
      if (lane == 0) {
        rsum[i0 + r] = sm;
        diag[i0 + r] = cs[r * pp + i0 + r];
      }
    }
    __syncthreads();  // the next rows overwrite cs
  }
}

template <class M>
__global__ void __launch_bounds__(kProThreads)
tcb_init(const float* __restrict__ xn, int K, int p, int strips, int nodes,
         int wdeg, const float* __restrict__ xs,
         const float* __restrict__ dct, float tau, float sb2, float s2,
         TcbPlan L, unsigned char* ws) {
  using T = typename M::T;
  __shared__ float wv[kMaxNodes];
  __shared__ float scal[1];  // lub
  const int b = blockIdx.x / strips,
            s0 = (blockIdx.x - b * strips) * kStrip;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pp = L.pp, nc = wdeg + 1;
  unsigned char* gw = ws + (size_t)b * L.group_bytes;
  const float* C = reinterpret_cast<const float*>(gw + L.s3f);
  const float* rsum = reinterpret_cast<const float*>(gw + L.rsum);
  const float* diag = reinterpret_cast<const float*>(gw + L.diag);
  // lub = max(min(trace, max row |sum|), 1.5 tau) * 1.02, in a fixed order
  if (warp == 0) {
    float tr = 0.f, rm = 0.f;
    for (int i = lane; i < p; i += 32) {
      tr += diag[i];
      rm = fmaxf(rm, rsum[i]);
    }
    tr = vnlb::warp_sum(tr);
    rm = vnlb::warp_max(rm);
    if (lane == 0) scal[0] = fmaxf(fminf(tr, rm), 1.5f * tau) * 1.02f;
  }
  __syncthreads();
  const float lub = scal[0];

  if (s0 == 0) {
    // the Wiener factor's node values, then its Chebyshev coefficients
    for (int n = tid; n < nodes; n += kProThreads) {
      const float lam = (xs[n] + 1.f) * 0.5f * lub;
      const float lc = fmaxf(lam, 0.9f * tau);
      wv[n] = (lc - sb2) / (lc - sb2 + s2);
    }
    __syncthreads();
    float* coef = reinterpret_cast<float*>(gw + L.coef);
    for (int j = warp; j < nc; j += kProThreads / 32) {
      float acc = 0.f;
      for (int n = lane; n < nodes; n += 32)
        acc = fmaf(wv[n], dct[n * nc + j], acc);
      acc = vnlb::warp_sum(acc);
      if (lane == 0) coef[j] = acc;
    }
  }

  // S_0 = st((C - tau I) / sc), Ah = st(2 C / lub - I), zero pad block,
  // two columns a lane; each division a product with the reciprocal, as
  // poly_tc_kernel's (within an ulp of the quotient before the rounding)
  const float rsc = 1.f / fmaxf(lub - tau, tau), rlub = 2.f / lub;
  T* Sa = reinterpret_cast<T*>(gw + L.sa);
  T* Ah = reinterpret_cast<T*>(gw + L.ah);
  const int s1 = min(pp, s0 + kStrip);
  for (int i = s0 + warp; i < s1; i += kProThreads / 32)
    for (int j = 2 * lane; j < pp; j += 64) {
      const size_t e = (size_t)i * pp + j;
      float sv[2] = {0.f, 0.f}, av[2] = {0.f, 0.f};
      if (i < p) {
        const float2 c = *reinterpret_cast<const float2*>(C + e);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (j + h >= p) break;
          const float cv = h ? c.y : c.x, d = i == j + h ? 1.f : 0.f;
          sv[h] = (cv - tau * d) * rsc;
          av[h] = cv * rlub - d;
        }
      }
      store2(Sa + e, sv[0], sv[1]);
      store2(Ah + e, av[0], av[1]);
    }
  // xn padded to kp x pp: three bf16 parts (hi + mid + lo = xn), or f32
  T* xp = reinterpret_cast<T*>(gw + L.xnp);
  const int Z = L.kp * pp;
  const size_t base = (size_t)b * K * p;
  for (int i = s0 + warp; i < min(L.kp, s1); i += kProThreads / 32)
    for (int j = lane; j < pp; j += 32) {
      const int e = i * pp + j;
      const float v = (i < K && j < p) ? __ldg(xn + base + i * p + j) : 0.f;
      if constexpr (M::kF32) {
        xp[e] = v;
      } else {
        const bf16 h = __float2bfloat16_rn(v);
        const float r1 = v - __bfloat162float(h);
        const bf16 m = __float2bfloat16_rn(r1);
        xp[e] = h;
        xp[Z + e] = m;
        xp[2 * Z + e] = __float2bfloat16_rn(r1 - __bfloat162float(m));
      }
    }
}

// ---- the batched product: one block per (group, 64 x 64 output tile) ----

enum Ep { kEpSt, kEpS3, kEpQ5, kEpPol, kEpZ0, kEpZ1, kEpZj };

struct MmArgs {
  unsigned char* ws;          // the sub-batch's workspace
  long long gbytes;           // bytes of one group's share
  long long a, b, a_part;     // byte offsets of A, B; bytes between A parts
  int parts, M, N;            // A parts (depth parts * N); rows; pp
  int tiles_n, tiles;         // output tiles of a group: columns, all
  int sym;                    // a symmetric product: the tiles on and
                              // above the diagonal, each stored twice
  long long d, d2, x1, x2;    // the epilogue's buffers (see Ep)
  long long zs;               // the running sum of coef_j z_j (f32)
  long long coef;
  const float* xn;            // the sub-batch's xn and out, (., K, p)
  float* out;
  int K, p, j;                // j: the step of z_j
  int last;                   // z_j is the last: the sum goes to out
  float qa, qb, qc;
};

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   tc::smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(tc::smem_addr(p)));
}

// acc[mt][nt] += A[warp rows + 16 mt ..][k] B[k][warp columns + 8 nt ..]
// over the first kv (a multiple of 16) of one stage's BK, for the warp's
// mt < mt_n, nt < nt_n
template <class M, class Tl = typename M::Tl>
__device__ __forceinline__ void stage_mma(float acc[Tl::MT][Tl::NT][4],
                                          const typename M::T* as,
                                          const typename M::T* bs, int m0,
                                          int n0, int mt_n, int nt_n,
                                          int kv) {
  constexpr int MT = Tl::MT, NT = Tl::NT, BLD = Tl::kBld, BK = Tl::BK;
  constexpr int ALD = BK + Tl::kPad;
  const int lane = threadIdx.x & 31;
  // the row of an ldmatrix.x4 address: matrices 0, 1 rows 0-7, 8-15
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8;
  if constexpr (!M::kF32) {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      if (kk >= kv) break;
      uint32_t af[MT][4], bf[NT / 2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        if (mt < mt_n)
          tc::ldsm_x4(af[mt], as + (m0 + 16 * mt + lr) * ALD + kk +
                                  (lane >> 4) * 8);
#pragma unroll
      for (int nh = 0; nh < NT / 2; ++nh)
        if (2 * nh < nt_n)
          ldsm_x4_t(bf[nh], bs + (kk + lr) * BLD + n0 + 16 * nh +
                                (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          if (mt < mt_n && nt < nt_n)
            tc::mma_bf16(acc[mt][nt], af[mt], bf[nt >> 1][2 * (nt & 1)],
                         bf[nt >> 1][2 * (nt & 1) + 1]);
    }
  } else {
    const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      if (kk >= kv) break;
      // A by ldmatrix (an 8 x 8 b16 matrix is 8 rows of four f32: lane l
      // gets row l / 4, word l % 4, the tf32 fragment's place)
      uint32_t ab[MT][4], asl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        if (mt < mt_n) {
          uint32_t u[4];
          tc::ldsm_x4(u, as + (m0 + 16 * mt + lr) * ALD + kk +
                             4 * (lane >> 4));
#pragma unroll
          for (int e = 0; e < 4; ++e)
            tc::split(__uint_as_float(u[e]), ab[mt][e], asl[mt][e]);
        }
      // every B fragment first, then the three terms in sweeps over the
      // warp's MT x NT accumulators (consecutive mma feed different ones)
      uint32_t bb[NT][2], bsl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        if (nt < nt_n) {
          const float* bp = bs + (kk + tq) * BLD + n0 + 8 * nt + gq;
          tc::split(bp[0], bb[nt][0], bsl[nt][0]);
          tc::split(bp[4 * BLD], bb[nt][1], bsl[nt][1]);
        }
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            if (mt < mt_n && nt < nt_n)
              tc::mma_term(t, acc[mt][nt], ab[mt], asl[mt], bb[nt][0],
                           bb[nt][1], bsl[nt][0], bsl[nt][1]);
    }
  }
}

// The epilogue of one output tile: v[mt][nt][h] are the warp's f32
// products (rows mrow + 16 mt + lane / 4 + 8 h, columns ncol + 8 nt + 2 (lane
// % 4) + 0, 1).  The values it reads are loaded before any is stored (the
// buffers may alias as far as the compiler knows; interleaved, each load
// would wait for the store before it).  `mirror`: a tile above the diagonal
// of a symmetric product, whose values are stored at (j, i) too.
template <class M, int EP, class Tl = typename M::Tl>
__device__ __forceinline__ void epilogue(const MmArgs& a, unsigned char* gw,
                                         int g, int mrow, int ncol,
                                         int mt_n, int nt_n, bool mirror,
                                         const float acc[Tl::MT][Tl::NT][4]) {
  using T = typename M::T;
  constexpr int MT = Tl::MT, NT = Tl::NT;
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int N = a.N;
  const size_t gkp = (size_t)g * a.K * a.p;
  const float* coef = reinterpret_cast<const float*>(gw + a.coef);
  auto xn_at = [&](int i, int j) {
    return (i < a.K && j < a.p) ? __ldg(a.xn + gkp + i * a.p + j) : 0.f;
  };
  auto out_put = [&](int i, int j, float v0, float v1) {
    if (i >= a.K) return;
    float* o = a.out + gkp + i * a.p + j;
    if (j < a.p) o[0] = v0;
    if (j + 1 < a.p) o[1] = v1;
  };
  // one row of m16 tiles at a time: the values read, two a pair, x1 (S,
  // z_0, z_{j-2} or xn) and x2 (S^3 or the running sum), then the stores;
  // the running sum goes to out at the last step, else to the workspace
  auto sum_put = [&](int i, int j, size_t e, float s0, float s1) {
    if (a.last)
      out_put(i, j, s0, s1);
    else
      store2(reinterpret_cast<float*>(gw + a.zs) + e, s0, s1);
  };
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (mt >= mt_n) break;
    float2 r1[NT][2], r2[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (nt >= nt_n) continue;
        const int i = mrow + 16 * mt + gq + 8 * h;
        const int j = ncol + 8 * nt + 2 * tq;
        const size_t e = (size_t)i * N + j;
        if constexpr (EP == kEpQ5 || EP == kEpPol)
          r1[nt][h] = load2(reinterpret_cast<const T*>(gw + a.x1) + e);
        if constexpr (EP == kEpQ5)
          r2[nt][h] = load2(reinterpret_cast<const float*>(gw + a.x2) + e);
        if constexpr (EP == kEpZ1 || EP == kEpZj)
          r1[nt][h] = load2(reinterpret_cast<const float*>(gw + a.x1) + e);
        if constexpr (EP == kEpZ0)
          r1[nt][h] = make_float2(xn_at(i, j), xn_at(i, j + 1));
        if constexpr (EP == kEpZj)
          r2[nt][h] = load2(reinterpret_cast<const float*>(gw + a.zs) + e);
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (nt >= nt_n) continue;
        const int i = mrow + 16 * mt + gq + 8 * h;
        const int j = ncol + 8 * nt + 2 * tq;
        const size_t e = (size_t)i * N + j;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        const float2 x = r1[nt][h], y = r2[nt][h];
        // a gate output at (i, j), (i, j + 1) and, mirrored, (j, i),
        // (j + 1, i)
        auto put = [&](auto* buf, float u0, float u1) {
          store2(buf + e, u0, u1);
          if (mirror) {
            using B = std::remove_pointer_t<decltype(buf)>;
            buf[(size_t)j * N + i] = to_t<B>(u0);
            buf[(size_t)(j + 1) * N + i] = to_t<B>(u1);
          }
        };
        if constexpr (EP == kEpSt) {
          // st(acc)
          put(reinterpret_cast<T*>(gw + a.d), v0, v1);
        } else if constexpr (EP == kEpS3) {
          // S^3 in f32 (d2) and st(S^3) (d)
          put(reinterpret_cast<float*>(gw + a.d2), v0, v1);
          if constexpr (!M::kF32) put(reinterpret_cast<T*>(gw + a.d), v0, v1);
        } else if constexpr (EP == kEpQ5) {
          // S = st(a S + b S^3 + c S^5) in place (d == x1)
          put(reinterpret_cast<T*>(gw + a.d),
              a.qa * x.x + a.qb * y.x + a.qc * v0,
              a.qa * x.y + a.qb * y.y + a.qc * v1);
        } else if constexpr (EP == kEpPol) {
          // S' = st(1.5 S - 0.5 S st(S S))
          put(reinterpret_cast<T*>(gw + a.d), 1.5f * x.x - 0.5f * v0,
              1.5f * x.y - 0.5f * v1);
        } else if constexpr (EP == kEpZ0) {
          // z_0 = xn W = (xn S + xn) / 2: f32 (d) and st(z_0) (d2)
          const float z0 = 0.5f * v0 + 0.5f * x.x;
          const float z1 = 0.5f * v1 + 0.5f * x.y;
          store2(reinterpret_cast<float*>(gw + a.d) + e, z0, z1);
          if constexpr (!M::kF32)
            store2(reinterpret_cast<T*>(gw + a.d2) + e, z0, z1);
        } else if constexpr (EP == kEpZ1) {
          // z_1 = st(z_0) Ah; the sum coef_0 z_0 + coef_1 z_1
          store2(reinterpret_cast<float*>(gw + a.d) + e, v0, v1);
          if constexpr (!M::kF32)
            store2(reinterpret_cast<T*>(gw + a.d2) + e, v0, v1);
          sum_put(i, j, e, coef[0] * x.x + coef[1] * v0,
                  coef[0] * x.y + coef[1] * v1);
        } else {
          // z_j = 2 st(z_{j-1}) Ah - z_{j-2} over z_{j-2} (d == x1); the
          // sum += coef_j z_j
          const float n0 = 2.f * v0 - x.x, n1 = 2.f * v1 - x.y;
          if (!a.last) {
            store2(reinterpret_cast<float*>(gw + a.d) + e, n0, n1);
            if constexpr (!M::kF32)
              store2(reinterpret_cast<T*>(gw + a.d2) + e, n0, n1);
          }
          const float cj = coef[a.j];
          sum_put(i, j, e, y.x + cj * n0, y.y + cj * n1);
        }
      }
  }
}

// The product kernel: one block per (group, output tile) of the launch's
// groups; a symmetric product's tiles run along the rows of the upper
// triangle.
template <class M, int EP, class Tl = typename M::Tl>
__global__ void __launch_bounds__(Tl::kThreads, Tl::kMinBlocks)
tcb_mm(MmArgs a) {
  using T = typename M::T;
  constexpr int BM = Tl::BM, BN = Tl::BN, MT = Tl::MT, NT = Tl::NT;
  constexpr int NTH = Tl::kThreads, BLD = Tl::kBld, BK = Tl::BK;
  constexpr int ALD = BK + Tl::kPad, NS = Tl::NS;
  constexpr int AS = BM * ALD, BS = BK * BLD;
  constexpr int EA = 16 / (int)sizeof(T);  // elements of a 16-byte copy
  extern __shared__ __align__(16) unsigned char mmsm[];
  T* As = reinterpret_cast<T*>(mmsm);
  T* Bs = As + NS * AS;
  const int g = blockIdx.x / a.tiles;
  int t = blockIdx.x - g * a.tiles, tm = 0, tn;
  if (a.sym) {
    while (t >= a.tiles_n - tm) t -= a.tiles_n - tm++;
    tn = tm + t;
  } else {
    tm = t / a.tiles_n;
    tn = t - tm * a.tiles_n;
  }
  unsigned char* gw = a.ws + (size_t)g * a.gbytes;
  const T* A = reinterpret_cast<const T*>(gw + a.a);
  const T* B = reinterpret_cast<const T*>(gw + a.b);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int N = a.N, row0 = tm * BM, col0 = tn * BN;
  const int m0 = (warp / Tl::WN) * (BM / Tl::WM),
            n0 = (warp % Tl::WN) * (BN / Tl::WN);
  const int nk = (N + BK - 1) / BK, nch = a.parts * nk;
  const int mrow = row0 + m0, ncol = col0 + n0;
  // the warp's m16 / n8 tiles inside the padded output (M, N multiples of
  // 16: a tile is wholly inside or wholly outside)
  const int mt_n = max(0, min(MT, (a.M - mrow) / 16));
  const int nt_n = max(0, min(NT, (N - ncol) / 8));

  auto load = [&](int c, int s) {
    const int part = c / nk, k0 = (c - part * nk) * BK;
    const T* Ap = reinterpret_cast<const T*>(
        reinterpret_cast<const unsigned char*>(A) + part * a.a_part);
    T* as = As + s * AS;
    T* bs = Bs + s * BS;
    for (int q = tid; q < BM * BK / EA; q += NTH) {
      const int r = q / (BK / EA), cc = (q - r * (BK / EA)) * EA;
      const int gr = row0 + r, gc = k0 + cc;
      const bool ok = gr < a.M && gc < N;
      cp16(as + r * ALD + cc, ok ? Ap + (size_t)gr * N + gc : Ap, ok);
    }
    for (int q = tid; q < BK * BN / EA; q += NTH) {
      const int r = q / (BN / EA), cc = (q - r * (BN / EA)) * EA;
      const int gr = k0 + r, gc = col0 + cc;
      const bool ok = gr < N && gc < N;
      cp16(bs + r * BLD + cc, ok ? B + (size_t)gr * N + gc : B, ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nch) load(s, s);
    tc::cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    tc::cp_async_wait<NS - 2>();
    __syncthreads();  // chunk c arrived; every warp is done with c - 1
    if (c + NS - 1 < nch) load(c + NS - 1, (c + NS - 1) % NS);
    tc::cp_async_commit();
    // the depth's last chunk may hold 16 of its 32 (N is a multiple of 16)
    const int kv = min(BK, N - (c % nk) * BK);
    if (mt_n > 0 && nt_n > 0)
      stage_mma<M>(acc, As + (c % NS) * AS, Bs + (c % NS) * BS, m0, n0,
                   mt_n, nt_n, kv);
  }
  tc::cp_async_wait<0>();
  if (mt_n > 0 && nt_n > 0)
    epilogue<M, EP>(a, gw, g, mrow, ncol, mt_n, nt_n, a.sym && tm != tn,
                    acc);
}

// one product over `groups` groups: a block per output tile
template <class M, int EP>
int launch_mm(const MmArgs& a, int groups, cudaStream_t st) {
  tcb_mm<M, EP><<<groups * a.tiles, M::Tl::kThreads, mm_smem<M>(), st>>>(a);
  return (int)cudaGetLastError();
}

template <class M>
int run(const float* xc, const float* xn, float* out, int G, int K, int p,
        int n_aggr, int n_polish, int wdeg, int nodes, const float* xs,
        const float* dct, float tau, float sb2, float s2, float qa, float qb,
        float qc, const TcbPlan& L, unsigned char* ws, cudaStream_t st) {
  const int psmem = (int)pro_smem(K, p);
  const int strips = (L.pp + kStrip - 1) / kStrip;
  auto smem = [](const void* k, int bytes) {
    return (int)cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  };
  int err = smem((const void*)&tcb_cov<M>, psmem);
  const void* mms[] = {(const void*)&tcb_mm<M, kEpSt>,
                       (const void*)&tcb_mm<M, kEpS3>,
                       (const void*)&tcb_mm<M, kEpQ5>,
                       (const void*)&tcb_mm<M, kEpPol>,
                       (const void*)&tcb_mm<M, kEpZ0>,
                       (const void*)&tcb_mm<M, kEpZ1>,
                       (const void*)&tcb_mm<M, kEpZj>};
  for (const void* k : mms)
    if (err == 0) err = smem(k, mm_smem<M>());
  if (err != 0) return err;
  const long long e = M::kF32 ? 4 : 2;
  for (int g0 = 0; g0 < G; g0 += L.batch) {
    const int nb = min(L.batch, G - g0);
    const size_t off = (size_t)g0 * K * p;
    tcb_cov<M><<<nb * strips, kProThreads, psmem, st>>>(xc + off, K, p,
                                                         strips, L, ws);
    tcb_init<M><<<nb * strips, kProThreads, 0, st>>>(
        xn + off, K, p, strips, nodes, wdeg, xs, dct, tau, sb2, s2, L, ws);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    MmArgs a = {};
    a.ws = ws;
    a.gbytes = L.group_bytes;
    a.parts = 1;
    a.N = L.pp;
    a.tiles_n = (L.pp + kTile - 1) / kTile;
    a.coef = L.coef;
    a.zs = L.zs;
    a.xn = xn + off;
    a.out = out + off;
    a.K = K;
    a.p = p;
    a.qa = qa;
    a.qb = qb;
    a.qc = qc;
    // a p x p product (the gate), or a kp x pp one (the recurrence)
    auto sq = [&](long long A, long long B) {
      MmArgs r = a;
      r.a = A;
      r.b = B;
      r.M = L.pp;
      r.tiles = L.tiles;
      r.sym = M::kF32;
      return r;
    };
    auto zr = [&](long long A, long long B) {
      MmArgs r = a;
      r.a = A;
      r.b = B;
      r.M = L.kp;
      r.tiles = L.ztiles;
      return r;
    };
    long long cur = L.sa, oth = L.sb;
    for (int it = 0; it < n_aggr && err == 0; ++it) {
      // S2 = st(S S), S3 = S2 S, S = st(a S + b S3 + c S2 st(S3))
      MmArgs r = sq(cur, cur);
      r.d = L.s2;
      err = launch_mm<M, kEpSt>(r, nb, st);
      if (err != 0) break;
      r = sq(L.s2, cur);
      r.d = L.s3b;
      r.d2 = L.s3f;
      err = launch_mm<M, kEpS3>(r, nb, st);
      if (err != 0) break;
      r = sq(L.s2, L.s3b);
      r.d = cur;
      r.x1 = cur;
      r.x2 = L.s3f;
      err = launch_mm<M, kEpQ5>(r, nb, st);
    }
    for (int it = 0; it < n_polish && err == 0; ++it) {
      // S' = st(1.5 S - 0.5 S st(S S))
      MmArgs r = sq(cur, cur);
      r.d = L.s2;
      err = launch_mm<M, kEpSt>(r, nb, st);
      if (err != 0) break;
      r = sq(cur, L.s2);
      r.d = oth;
      r.x1 = cur;
      err = launch_mm<M, kEpPol>(r, nb, st);
      const long long t = cur;
      cur = oth;
      oth = t;
    }
    if (err != 0) return err;
    // z_0 = (xn S + xn) / 2 (xn in three bf16 parts, or f32), z_1, z_j
    MmArgs r = zr(L.xnp, cur);
    r.parts = M::kF32 ? 1 : 3;
    r.a_part = (long long)L.kp * L.pp * e;
    r.d = L.zf0;
    r.d2 = L.zb0;
    if ((err = launch_mm<M, kEpZ0>(r, nb, st)) != 0) return err;
    r = zr(L.zb0, L.ah);
    r.d = L.zf1;
    r.d2 = L.zb1;
    r.x1 = L.zf0;
    r.last = wdeg == 1;
    if ((err = launch_mm<M, kEpZ1>(r, nb, st)) != 0) return err;
    const long long zf[2] = {L.zf0, L.zf1}, zb[2] = {L.zb0, L.zb1};
    for (int j = 2; j <= wdeg; ++j) {
      r = zr(zb[(j - 1) & 1], L.ah);
      r.d = zf[j & 1];
      r.d2 = zb[j & 1];
      r.x1 = zf[j & 1];
      r.j = j;
      r.last = j == wdeg;
      if ((err = launch_mm<M, kEpZj>(r, nb, st)) != 0) return err;
    }
  }
  return 0;
}

}  // namespace

// The batched design's plan for G groups of (K, p) (bf16 operands when
// rnd, else split TF32): v[0..6]
// = padded p, padded K, output tiles of a p x p and of a K x p product,
// groups per sub-batch, bytes of one group's workspace, bytes of the
// workspace (all 0: the design does not take (K, p)).  Returns 0.
extern "C" int vnlb_poly_filter_tcb_plan(int G, int K, int p, int rnd,
                                         long long* v) {
  const TcbPlan L = tcb_plan(G, K, p, !rnd);
  v[0] = L.pp;
  v[1] = L.kp;
  v[2] = L.tiles;
  v[3] = L.ztiles;
  v[4] = L.pp ? L.batch : 0;
  v[5] = L.group_bytes;
  v[6] = L.pp ? L.group_bytes * L.batch : 0;
  return 0;
}

// The batched design on (G, K, p) groups, K < p (arguments as
// vnlb_poly_filter_tc's; ws: ws_bytes of device memory, at least the
// plan's workspace); cudaErrorInvalidValue for a shape it
// does not take or a workspace too small.
extern "C" int vnlb_poly_filter_tcb(const float* xc, const float* xn,
                                    float* out, int G, int K, int p,
                                    int n_aggr, int n_polish, int wdeg,
                                    int nodes, const float* xs,
                                    const float* dct, float tau, float sb2,
                                    float s2, float qa, float qb, float qc,
                                    int rnd, void* ws, long long ws_bytes,
                                    void* stream) {
  if (G <= 0) return 0;
  const TcbPlan L = tcb_plan(G, K, p, !rnd);
  if (L.pp == 0 || nodes > kMaxNodes || wdeg + 1 > kMaxCoef || wdeg < 1 ||
      ws == nullptr || ws_bytes < L.group_bytes * L.batch)
    return (int)cudaErrorInvalidValue;
  unsigned char* w = static_cast<unsigned char*>(ws);
  const cudaStream_t st = (cudaStream_t)stream;
  return rnd ? run<Bf16Mode>(xc, xn, out, G, K, p, n_aggr, n_polish, wdeg,
                             nodes, xs, dct, tau, sb2, s2, qa, qb, qc, L, w,
                             st)
             : run<Tf32Mode>(xc, xn, out, G, K, p, n_aggr, n_polish, wdeg,
                             nodes, xs, dct, tau, sb2, s2, qa, qb, qc, L, w,
                             st);
}
