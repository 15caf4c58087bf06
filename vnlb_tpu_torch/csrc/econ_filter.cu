// K2: the economized polynomial spectral filter, one patch group per block.
//
// Replaces the Pallas kernel vnlb_tpu/ops/pallas_filter.py:106
// (`_filter_kernel`, launched at pallas_filter.py:260 by
// `poly_econ_gram_packed_pallas` and at :320 by `poly_econ_packed_pallas`),
// which computes the same function as the XLA routes of
// vnlb_tpu/ops/polyspec.py `poly_filter_econ`: `_poly_econ_packed` and the
// unpacked matrix route (K >= p), `_poly_econ_gram_packed` and
// `_poly_econ_gram` (K < p, Gram route).  The TPU packs two groups per
// 128-lane tile; that is a layout device of the MXU and is dropped: a
// group's math is identical packed or alone.
//
// Per group (xc, xn: K x p, centred patches):
//   matrix route (q = p): A = 2 (xc^T xc / K) / lub - I
//   Gram route   (q = K): A = 2 (xc xc^T / K) / lub - I
//   lub = max(min(trace, max row |sum|), 1.5 tau) * 1.02
//   fv  = smoothed gate x Wiener transfer at the Chebyshev nodes scaled
//         to [0, lub]; gam = fv @ proj (m*s econ coefficients), f0 = fv @ v0
//   chain: T_r(A) (r < s), B = T_s(A), V_i = sum_r gam[i,r] T_r,
//          Clenshaw in B:  F = sum_i T_i(B) V_i
//   matrix route: out = xn F
//   Gram route:   out = f0 xn + (xn xc^T) F xc * 2 / (K lub)
// Cast points follow polyspec (not the Pallas kernel): the covariance,
// Gram and xn xc^T products take f32 operands; every chain product and the
// final application take bf16-rounded operands (`rnd`), accumulated in f32.
//
// What bounds it on the H100: arithmetic.  A stage-1 group (K=60, p=98)
// reads and writes 3 x 23.5 KB and does ~2.8 M multiply-adds, ~40 FMAs per
// byte; the chain is seven dependent q x q products.  Four designs
// (ops/econ_filter.py `design`):
//
// The tensor-core design (`econ_tc_kernel`, econ_tc.cuh at width 64) takes
// the groups with q <= 64 under poly_bf16 whose buffers leave room for two
// blocks per SM: the main path's matrix (100, 49) and Gram (60, 98)
// groups.  A block of 256 threads walks its groups; q is padded to 64 with
// a zero block, so every chain product is one 64 x 64 x 64 mma.sync (bf16
// operands, f32 accumulation) per group, split over 8 warps.  The f32
// state (A, T_2, T_3, the Clenshaw pair) stays in the accumulator
// registers of the thread that computed it; each operand goes to shared
// memory once, rounded to bf16 when stored.  The covariance / Gram and xn
// xc^T products (f32 operands) run on CUDA cores, 8x8 outputs per thread
// over a quarter of the depth, and land in the same register layout; they
// are ~25% of a Gram group's multiply-adds and set its operation bound.
// One barrier per chain step.
//
// The wide tensor-core design (`econ_tcw_kernel<W, Op>`, its note below)
// takes the matrix route's other groups with q <= 128 whose buffers fit:
// under poly_bf16 64 < q (the pt=2 first pass of presets `default` and
// `sss`, (100, 98)), without it every q (width 64 for (100, 49), 128 for
// (100, 98)).
//
// The streamed Gram route (`econ_tcg_kernel<W, Op>`, its note below) takes
// the Gram route's other groups with K <= 128: `couple_channels`' joint
// groups (p = 3 x 49 or 3 x 98, whose p rows of xc^T the width-64 design
// cannot hold) and, without poly_bf16, (60, 98).
//
// Without poly_bf16 both run every product with f32 operands in split
// TF32 (econ_tc.cuh `OpTf32`: three TF32 mma of operands split in
// registers into big + small, f32 accumulation), the same chain as under
// poly_bf16 on f32 operand buffers; the bf16 instantiations are the
// designs they were.
//
// The shared-memory design (`econ_filter_kernel`, group_mm.cuh) takes
// every other shape (Gram groups with K > 128, groups beyond the
// tensor-core designs' shared memory) and is the comparison the card's
// checks time beside each tensor-core design (`smem_design`): the group's
// two patch blocks and seven q x q f32 matrices in shared memory when they
// fit, the products on CUDA cores with a 2x2 tile of outputs per thread,
// operands rounded to bf16 in registers.  Groups beyond shared memory
// (up to 515 KB at couple_channels' (100, 294)) place their buffers by
// priority (group_mm.cuh `plan_slots`), the most-read q x q matrices
// first, the patch blocks last; a matrix that does not fit lives in the
// block's slice of a workspace in device memory, and a patch block that
// does not fit is read in place from the input.  A spilling launch runs a
// persistent grid of one block per resident slot, so the workspace is
// (blocks x spilled floats) and stays in L2.

#include <type_traits>

#include "econ_tc.cuh"
#include "group_mm.cuh"

namespace {

using vnlb::block_mm;
using vnlb::mm_r;

constexpr int kThreads = 512;
constexpr int kMaxNodes = 128;
constexpr int kMaxCoef = 64;

// buffers in placement priority: A, A^2, B = T_s(A), product scratch,
// Clenshaw state (two), T_3(A), then the xc and xn patch blocks
enum { kA, kA2, kB, kP, kHi, kLo, kT3, kXc, kXn, kSlots };

vnlb::SlotPlan econ_plan(int K, int p) {
  const long long q = K < p ? K : p, qq = q * q, kp = (long long)K * p;
  const long long floats[kSlots] = {qq, qq, qq, qq, qq, qq, qq, kp, kp};
  const bool input[kSlots] = {false, false, false, false, false,
                              false, false, true,  true};
  return vnlb::plan_slots(kSlots, floats, input);
}

// square q x q product with bf16 or f32 operands
template <bool XFORM>
__device__ __forceinline__ void sq_mm(float* C, const float* A,
                                      const float* B, int q, bool rnd,
                                      float alpha = 1.f, float beta = 0.f) {
  if (rnd)
    block_mm<false, false, true, true, XFORM>(C, q, A, q, B, q, q, q, q,
                                              alpha, beta, 1.f, nullptr, 0.f);
  else
    block_mm<false, false, false, false, XFORM>(C, q, A, q, B, q, q, q, q,
                                                alpha, beta, 1.f, nullptr,
                                                0.f);
}

template <bool kSh, bool kInSh>
__global__ void __launch_bounds__(kThreads)
econ_filter_kernel(const float* __restrict__ xc, const float* __restrict__ xn,
                   float* __restrict__ out, int G, int K, int p, int m, int s,
                   int nodes, const float* __restrict__ xs,
                   const float* __restrict__ proj,
                   const float* __restrict__ v0, float tau, float lub_floor,
                   float sb2, float s2, float cwg, int rnd,
                   vnlb::SlotPlan pl, float* ws) {
  extern __shared__ float sm[];
  __shared__ float fv[kMaxNodes];
  __shared__ float gam[kMaxCoef];
  __shared__ float scal[2];  // lub, f0

  const bool gram = K < p;
  const int q = gram ? K : p;
  const int kp = K * p, qq = q * q, ms = m * s;
  const int tid = threadIdx.x;
  float* wsb = ws == nullptr ? nullptr : ws + blockIdx.x * pl.ws_floats;
  float* Ma = vnlb::slot<kSh>(pl, kA, sm, wsb);    // A
  float* Mb = vnlb::slot<kSh>(pl, kA2, sm, wsb);   // A^2
  float* Mc = vnlb::slot<kSh>(pl, kB, sm, wsb);    // B = T_s(A)
  float* Md = vnlb::slot<kSh>(pl, kT3, sm, wsb);   // T_3(A) when s == 4
  float* b_hi = vnlb::slot<kSh>(pl, kHi, sm, wsb); // Clenshaw state
  float* b_lo = vnlb::slot<kSh>(pl, kLo, sm, wsb);
  float* P = vnlb::slot<kSh>(pl, kP, sm, wsb);     // product scratch
  float* Xc_s = vnlb::slot<kInSh>(pl, kXc, sm, wsb);
  float* Xn_s = vnlb::slot<kInSh>(pl, kXn, sm, wsb);
  const bool r16 = rnd != 0;
  const float invk = 1.f / (float)K;

  // V_i(e) = sum_r gam[i, r] T_r(A)[e]
  auto v_elem = [&](int i, int e) -> float {
    const int r0 = e / q, c0 = e - r0 * q;
    const float* g = gam + i * s;
    float v = g[0] * (r0 == c0 ? 1.f : 0.f);
    v = v + g[1] * Ma[e];
    if (s >= 3) v = v + g[2] * (2.f * Mb[e] - (r0 == c0 ? 1.f : 0.f));
    if (s == 4) v = v + g[3] * Md[e];
    return v;
  };

  for (int grp = blockIdx.x; grp < G; grp += gridDim.x) {
    const size_t base = (size_t)grp * kp;
    const float *X1, *X2;
    vnlb::load_inputs<kInSh>(pl, kXc, kXn, Xc_s, Xn_s, xc + base, xn + base,
                             kp, &X1, &X2);
    __syncthreads();

    // covariance (matrix route) or Gram (Gram route), f32 operands
    if (gram)
      block_mm<false, true, false, false, false>(Ma, q, X1, p, X1, p, q, p, q,
                                                 1.f, 0.f, invk, nullptr,
                                                 0.f);
    else
      block_mm<true, false, false, false, false>(Ma, q, X1, p, X1, p, q, K, q,
                                                 1.f, 0.f, invk, nullptr,
                                                 0.f);
    __syncthreads();
    vnlb::spectral_bound(Ma, q, P, lub_floor, &scal[0]);
    const float lub = scal[0];

    // transfer values at the scaled Chebyshev nodes
    for (int n = tid; n < nodes; n += blockDim.x) {
      const float lam = (xs[n] + 1.f) * 0.5f * lub;
      const float wg = cwg * sqrtf(tau * lub);
      const float z = (lam - tau) / (wg / 4.4f);
      const float gate = 1.f / (1.f + expf(-z));
      const float lam_s = fmaxf(lam - sb2, 0.f);
      fv[n] = gate * lam_s / (lam_s + s2);
    }
    __syncthreads();
    for (int j = tid; j < ms + 1; j += blockDim.x) {
      float acc = 0.f;
      if (j < ms) {
        for (int n = 0; n < nodes; ++n)
          acc = fmaf(fv[n], proj[n * ms + j], acc);
        gam[j] = acc;
      } else if (v0 != nullptr) {
        for (int n = 0; n < nodes; ++n) acc = fmaf(fv[n], v0[n], acc);
        scal[1] = acc;
      }
    }
    // A = M * (2 / lub) - I
    const float sc = 2.f / lub;
    for (int e = tid; e < qq; e += blockDim.x) {
      const int i = e / q, j = e - i * q;
      Ma[e] = Ma[e] * sc - (i == j ? 1.f : 0.f);
      b_hi[e] = 0.f;
      b_lo[e] = 0.f;
    }
    __syncthreads();

    // T_r(A) for r < s and B = T_s(A)
    sq_mm<false>(Mb, Ma, Ma, q, r16);  // A^2
    __syncthreads();
    if (s == 4) {
      sq_mm<false>(P, Mb, Mb, q, r16);  // A^4
      __syncthreads();
      for (int e = tid; e < qq; e += blockDim.x) {
        const int i = e / q, j = e - i * q;
        Mc[e] = 8.f * P[e] - 8.f * Mb[e] + (i == j ? 1.f : 0.f);
      }
      sq_mm<true>(Md, Mb, Ma, q, r16, 4.f, -3.f);  // (4 A^2 - 3) A
    } else if (s == 3) {
      sq_mm<true>(Mc, Mb, Ma, q, r16, 4.f, -3.f);
    } else {
      for (int e = tid; e < qq; e += blockDim.x) {
        const int i = e / q, j = e - i * q;
        Mc[e] = 2.f * Mb[e] - (i == j ? 1.f : 0.f);
      }
    }
    __syncthreads();

    // Clenshaw in B over i = m-1 .. 1 (the first step has b_hi = 0)
    float* hi = b_hi;
    float* lo = b_lo;
    for (int i = m - 1; i >= 1; --i) {
      if (i < m - 1) {
        sq_mm<false>(P, hi, Mc, q, r16);
        __syncthreads();
      }
      for (int e = tid; e < qq; e += blockDim.x) {
        const float prod = (i < m - 1) ? P[e] : 0.f;
        lo[e] = v_elem(i, e) + 2.f * prod - lo[e];
      }
      __syncthreads();
      float* tmp = hi;
      hi = lo;
      lo = tmp;
    }
    // F = V_0 + hi B - lo, into P
    if (m > 1) {
      sq_mm<false>(P, hi, Mc, q, r16);
      __syncthreads();
    }
    for (int e = tid; e < qq; e += blockDim.x) {
      const float prod = (m > 1) ? P[e] : 0.f;
      P[e] = v_elem(0, e) + prod - lo[e];
    }
    __syncthreads();

    float* o = out + base;
    if (!gram) {
      // out = xn F
      mm_r(o, p, X2, p, P, q, K, p, p, r16);
    } else {
      // Gram route: mh = xn xc^T (f32), t = mh F,
      // out = f0 xn + t xc * 2/(K lub)
      block_mm<false, true, false, false, false>(Ma, q, X2, p, X1, p, K, p, K,
                                                 1.f, 0.f, 1.f, nullptr, 0.f);
      __syncthreads();
      sq_mm<false>(Mb, Ma, P, q, r16);
      __syncthreads();
      const float yscale = 2.f / ((float)K * lub);
      if (r16)
        block_mm<false, false, true, true, false>(o, p, Mb, q, X1, p, K, K, p,
                                                  1.f, 0.f, yscale, X2,
                                                  scal[1]);
      else
        block_mm<false, false, false, false, false>(o, p, Mb, q, X1, p, K, K,
                                                    p, 1.f, 0.f, yscale, X2,
                                                    scal[1]);
    }
    __syncthreads();  // the next group overwrites the slots
  }
}

// The instantiation for a plan: shared-memory pointers where the plan
// keeps every scratch buffer (and both patch blocks) in shared memory.
using EconKernel = decltype(&econ_filter_kernel<true, true>);

EconKernel pick_kernel(const vnlb::SlotPlan& pl) {
  if (!vnlb::scratch_shared(pl)) return &econ_filter_kernel<false, false>;
  if (!vnlb::inputs_shared(pl, kXc, kXn))
    return &econ_filter_kernel<true, false>;
  return &econ_filter_kernel<true, true>;
}

// ---- the tensor-core design (econ_tc.cuh) ----

namespace tc = vnlb::tc;
using bf16 = __nv_bfloat16;

// Dynamic shared memory of a tensor-core block for (K, p) groups, or 0
// when the design does not take them (q > 64, a Gram route with p > 128,
// or more than two blocks' worth of an SM).  Layout, in order:
//   Gram route (K < p): xc^T, xn^T f32, p rows x kLdk each;
//   matrix route:       xc f32, K rows x kLdk, then bf16(xn),
//                       round_up(K, 16) rows x kLdb;
//   then kNumBufs bf16 operand buffers of kBuf.
// ops/econ_filter.py `tc_smem_bytes` mirrors this.
int tc_smem(int K, int p) {
  const int q = K < p ? K : p;
  if (q > tc::kQ || q < 1) return 0;
  long long n = (long long)tc::kNumBufs * tc::kBuf * 2;
  if (K < p) {
    if (tc::round_up(p, 8) > 2 * tc::kQ) return 0;
    n += 2LL * p * tc::kLdk * 4;
  } else {
    n += (long long)K * tc::kLdk * 4 +
         (long long)tc::round_up(K, 16) * tc::kLdb * 2;
  }
  return n <= tc::kSmemMax ? (int)n : 0;
}

// node tables (xs, proj, v0) a block copies to shared memory when they fit
constexpr int kTab = 1536;

__global__ void __launch_bounds__(tc::kThreads, 2)
econ_tc_kernel(const float* __restrict__ xc, const float* __restrict__ xn,
               float* __restrict__ out, int G, int K, int p, int m, int s,
               int nodes, const float* __restrict__ xs,
               const float* __restrict__ proj, const float* __restrict__ v0,
               float tau, float lub_floor, float sb2, float s2, float cwg,
               int smem_bytes) {
  extern __shared__ __align__(16) unsigned char smraw[];
  __shared__ float fv[kMaxNodes];
  __shared__ float gam[kMaxCoef];
  __shared__ float scal[2];  // lub, f0
  __shared__ float rowpart[2][tc::kQ];
  __shared__ float diagv[tc::kQ];
  __shared__ float tab[kTab];

  const bool gram = K < p;
  const int q = gram ? K : p;
  const int kp = K * p, ms = m * s, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int kt_q = (q + 15) / 16;
  // Gram route: Xa = xc^T, Xb = xn^T (p rows); matrix route: Xa = xc
  // (K rows), XnB = bf16(xn) (K rows); k-major, so row k holds the q
  // output indices of the f32 products
  float* Xa = reinterpret_cast<float*>(smraw);
  float* Xb = Xa + (gram ? p : K) * tc::kLdk;
  bf16* XnB = reinterpret_cast<bf16*>(Xb);
  bf16* buf0 = reinterpret_cast<bf16*>(
      gram ? Xb + p * tc::kLdk
           : reinterpret_cast<float*>(XnB + tc::round_up(K, 16) * tc::kLdb));
  bf16* buf1 = buf0 + tc::kBuf;
  bf16* buf2 = buf1 + tc::kBuf;
  bf16* buf3 = buf2 + tc::kBuf;
  float* part = reinterpret_cast<float*>(buf0);  // syrk's slice sums
  const tc::Pos ps;
  const float invk = 1.f / (float)K;

  // zero once: the pad rows and columns of the patch blocks are never
  // written again; the node tables into shared memory when they fit
  for (int e = tid; e < smem_bytes / 4; e += blockDim.x)
    reinterpret_cast<float*>(smraw)[e] = 0.f;
  const int n_tab = nodes * (ms + 1 + (v0 != nullptr));
  if (n_tab <= kTab) {
    for (int e = tid; e < n_tab; e += blockDim.x)
      tab[e] = e < nodes ? xs[e]
               : e < nodes * (ms + 1) ? proj[e - nodes]
                                      : v0[e - nodes * (ms + 1)];
    xs = tab;
    proj = tab + nodes;
    if (v0 != nullptr) v0 = tab + nodes * (ms + 1);
  }
  __syncthreads();

  float A[16], T2[16], T3[16], hi[16], lo[16], P[16];

  // the load loop walks e = tid + u kThreads with (r, c) = divmod(e, p)
  const int dr = tc::kThreads / p, dc = tc::kThreads - dr * p;
  for (int grp = blockIdx.x; grp < G; grp += gridDim.x) {
    const size_t base = (size_t)grp * kp;
    {
      // kUnroll loads of each block in flight per thread: one round for
      // the main path's groups (K p <= 6144)
      constexpr int kUnroll = 24;
      int r = tid / p, c = tid - (tid / p) * p;
      for (int e0 = tid; e0 < kp; e0 += kUnroll * tc::kThreads) {
        float a[kUnroll], b[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int e = e0 + u * tc::kThreads;
          a[u] = e < kp ? xc[base + e] : 0.f;
          b[u] = e < kp ? xn[base + e] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (e0 + u * tc::kThreads >= kp) break;
          if (gram) {
            Xa[c * tc::kLdk + r] = a[u];
            Xb[c * tc::kLdk + r] = b[u];
          } else {
            Xa[r * tc::kLdk + c] = a[u];
            XnB[r * tc::kLdb + c] = __float2bfloat16_rn(b[u]);
          }
          c += dc;
          r += dr;
          if (c >= p) {
            c -= p;
            ++r;
          }
        }
      }
    }
    __syncthreads();

    // covariance (matrix route) or Gram (Gram route), f32 operands
    tc::syrk(A, Xa, Xa, gram ? p : K, part, ps);
#pragma unroll
    for (int k = 0; k < 16; ++k) A[k] *= invk;

    // lub = max(min(trace, max row |sum|), floor) * 1.02
    {
      float ra = 0.f, rb = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if (k & 2)
          rb += fabsf(A[k]);
        else
          ra += fabsf(A[k]);
        if (ps.row(k) == ps.col(k)) diagv[ps.row(k)] = A[k];
      }
      ra += __shfl_xor_sync(0xffffffffu, ra, 1);
      rb += __shfl_xor_sync(0xffffffffu, rb, 1);
      ra += __shfl_xor_sync(0xffffffffu, ra, 2);
      rb += __shfl_xor_sync(0xffffffffu, rb, 2);
      if ((lane & 3) == 0) {
        rowpart[warp & 1][ps.r0] = ra;
        rowpart[warp & 1][ps.r0 + 8] = rb;
      }
    }
    __syncthreads();
    if (warp == 0) {
      const float tr = vnlb::warp_sum(diagv[lane] + diagv[lane + 32]);
      const float rs = vnlb::warp_max(
          fmaxf(rowpart[0][lane] + rowpart[1][lane],
                rowpart[0][lane + 32] + rowpart[1][lane + 32]));
      if (lane == 0) scal[0] = fmaxf(fminf(tr, rs), lub_floor) * 1.02f;
    }
    __syncthreads();
    const float lub = scal[0];

    // transfer values at the scaled Chebyshev nodes, then gam and f0
    for (int n = tid; n < nodes; n += blockDim.x) {
      const float lam = (xs[n] + 1.f) * 0.5f * lub;
      const float wg = cwg * sqrtf(tau * lub);
      const float z = (lam - tau) / (wg / 4.4f);
      const float gate = 1.f / (1.f + expf(-z));
      const float lam_s = fmaxf(lam - sb2, 0.f);
      fv[n] = gate * lam_s / (lam_s + s2);
    }
    __syncthreads();
    // one warp per coefficient, the nodes over its lanes
    for (int j = warp; j < ms + (v0 != nullptr); j += tc::kThreads / 32) {
      float acc = 0.f;
      for (int n = lane; n < nodes; n += 32)
        acc = fmaf(fv[n], j < ms ? proj[n * ms + j] : v0[n], acc);
      acc = vnlb::warp_sum(acc);
      if (lane == 0) (j < ms ? gam[j] : scal[1]) = acc;
    }

    // A = M * (2 / lub) - I
    const float sc = 2.f / lub;
#pragma unroll
    for (int k = 0; k < 16; ++k) A[k] = A[k] * sc - tc::diag(ps, k, q);
    tc::store_row(buf0, ps, [&](int k) { return A[k]; });
    tc::store_colT(buf1, ps, [&](int k) { return A[k]; });
    __syncthreads();

    // A^2 into T2; then B = T_s(A) (B-side operand, buf2) and T_3
    tc::mma_q(T2, buf0, buf1, kt_q);
    __syncthreads();
    if (s == 2) {
      tc::store_colT(buf2, ps,
                     [&](int k) { return 2.f * T2[k] - tc::diag(ps, k, q); });
    } else {
      tc::store_row(buf3, ps, [&](int k) {
        return 4.f * T2[k] - 3.f * tc::diag(ps, k, q);
      });
      if (s == 4) {
        tc::store_row(buf0, ps, [&](int k) { return T2[k]; });
        tc::store_colT(buf2, ps, [&](int k) { return T2[k]; });
      }
      __syncthreads();
      if (s == 4) {
        tc::mma_q(P, buf0, buf2, kt_q);   // A^4
        tc::mma_q(T3, buf3, buf1, kt_q);  // (4 A^2 - 3) A
      } else {
        tc::mma_q(P, buf3, buf1, kt_q);   // B = T_3(A)
      }
      __syncthreads();
      if (s == 4)
        tc::store_colT(buf2, ps, [&](int k) {
          return 8.f * P[k] - 8.f * T2[k] + tc::diag(ps, k, q);
        });
      else
        tc::store_colT(buf2, ps, [&](int k) { return P[k]; });
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) T2[k] = 2.f * T2[k] - tc::diag(ps, k, q);

    // V_i = sum_r gam[i, r] T_r(A) at fragment element k
    auto v_at = [&](int i, int k) -> float {
      const float* g = gam + i * s;
      float v = g[0] * tc::diag(ps, k, q);
      v = v + g[1] * A[k];
      if (s >= 3) v = v + g[2] * T2[k];
      if (s == 4) v = v + g[3] * T3[k];
      return v;
    };

    // Clenshaw in B over i = m-1 .. 1 (the first step has hi = 0); the hi
    // operand alternates between buf0 and buf1, so one barrier per step
#pragma unroll
    for (int k = 0; k < 16; ++k) hi[k] = lo[k] = 0.f;
    bf16* hbuf = buf0;
    for (int i = m - 1; i >= 1; --i) {
      if (i < m - 1) {
        tc::store_row(hbuf, ps, [&](int k) { return hi[k]; });
        __syncthreads();
        tc::mma_q(P, hbuf, buf2, kt_q);
        hbuf = hbuf == buf0 ? buf1 : buf0;
      } else {
#pragma unroll
        for (int k = 0; k < 16; ++k) P[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const float nw = v_at(i, k) + 2.f * P[k] - lo[k];
        lo[k] = hi[k];
        hi[k] = nw;
      }
    }
    // F = V_0 + hi B - lo, into P
    if (m > 1) {
      tc::store_row(hbuf, ps, [&](int k) { return hi[k]; });
      __syncthreads();
      tc::mma_q(P, hbuf, buf2, kt_q);
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k) P[k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) P[k] = v_at(0, k) + P[k] - lo[k];
    __syncthreads();  // every operand buffer is free again

    // applications in rows of m16n8 tiles: mt x ns units over the warps,
    // a unit being one 16-row tile and a run of nh <= 8 column tiles
    float* o = out + base;
    const int mt = (K + 15) / 16, nt = (p + 7) / 8;
    const int ns = mt >= 8 ? 1 : 8 / mt, nh = (nt + ns - 1) / ns;
    if (!gram) {
      // out = xn F
      tc::store_colT(buf0, ps, [&](int k) { return P[k]; });
      __syncthreads();
      for (int u = warp; u < mt * ns; u += tc::kThreads / 32) {
        const int mi = u / ns, n_lo = (u - mi * ns) * nh;
        const int cnt = min(nh, nt - n_lo);
        if (cnt <= 0) continue;
        float c[8][4];
        tc::mma_rows(c, XnB, 16 * mi, buf0, 8 * n_lo, cnt, kt_q);
        tc::apply_rows(o, K, p, 16 * mi, 8 * n_lo, cnt, c,
                       [&](int, int, float v) { return v; });
      }
    } else {
      // mh = xn xc^T (f32), t = mh F, out = f0 xn + t xc * 2/(K lub)
      tc::syrk(A, Xb, Xa, p, part, ps);
      tc::store_colT(buf0, ps, [&](int k) { return P[k]; });
      tc::store_row(buf1, ps, [&](int k) { return A[k]; });
      // bf16(xc)^T (p rows, K columns, zero beyond) over buf2 and buf3
      for (int e = tid; e < p * tc::kQ; e += tc::kThreads)
        buf2[(e >> 6) * tc::kLdb + (e & 63)] =
            __float2bfloat16_rn(Xa[(e >> 6) * tc::kLdk + (e & 63)]);
      __syncthreads();
      tc::mma_q(P, buf1, buf0, kt_q);
      __syncthreads();
      tc::store_row(buf0, ps, [&](int k) { return P[k]; });
      __syncthreads();
      const float yscale = 2.f / ((float)K * lub), f0 = scal[1];
      for (int u = warp; u < mt * ns; u += tc::kThreads / 32) {
        const int mi = u / ns, n_lo = (u - mi * ns) * nh;
        const int cnt = min(nh, nt - n_lo);
        if (cnt <= 0) continue;
        float c[8][4];
        tc::mma_rows(c, buf0, 16 * mi, buf2, 8 * n_lo, cnt, kt_q);
        tc::apply_rows(o, K, p, 16 * mi, 8 * n_lo, cnt, c,
                       [&](int r, int col, float v) {
                         return f0 * Xb[col * tc::kLdk + r] + v * yscale;
                       });
      }
    }
    __syncthreads();  // the next group overwrites the patch blocks
  }
}

// Blocks of a tensor-core launch: one per resident slot (at most G).
int tc_grid(int G, int smem, int* grid, int* per_sm) {
  return tc::occupancy_grid((const void*)econ_tc_kernel, tc::kThreads, smem,
                            G, grid, per_sm);
}

// ---- the wide tensor-core design ("tcw", econ_tc.cuh) ----
//
// The matrix route's groups (K >= p) that the width-64 design does not
// take.  Under poly_bf16, 64 < q = p <= 128 whose buffers fit one block
// per SM (preset `default`'s and `sss`'s pt=2 first pass, (100, 98); A,
// T_2 and T_3 in f32 leave room up to q = 104), at width W = 128.
// Without poly_bf16, every q = p <= 128 whose buffers fit, in split TF32
// (econ_tc.cuh `OpTf32`): width 64 (256 threads, two blocks per SM) for q
// <= 64, the (100, 49) groups, and 128 for the (100, 98) groups, whose
// f32 operand buffers hold round_up(q, 8) = 104 rows of 108 floats
// (44,928 bytes), so the chain takes 212,160 bytes and the application
// 215,616.  A block walks its groups; every chain product and the
// application is a padded W x W mma.sync (bf16 operands, or three TF32
// products of split f32 operands), f32 accumulation.  Registers hold two
// f32 states, the Clenshaw pair; A, T_2 and T_3, which every Clenshaw
// step reads in f32 for V_i, sit in shared memory as f32 q x q matrices at
// a row stride of 8 mod 32 floats (`tcw_ldt`: the float2 reads of a
// half-warp meet no bank twice); the operands are two buffers, B =
// T_s(A) and the Clenshaw state (the chain's first products use them
// too).  Each Clenshaw product adds hi B to (V_i - lo) / 2 in the
// accumulators and doubles it, so no third state is held.  Phases share
// the shared memory: xc (f32) and the covariance's scratch, then the
// chain, then xn (bf16, or f32 in split TF32; read from device memory at
// the end) over the Clenshaw buffer.
constexpr int kTcwMax = 220 * 1024;

__host__ __device__ inline int tcw_ldt(int q) {
  return tc::round_up(q > 8 ? q - 8 : 0, 32) + 8;
}

// dynamic shared memory a block may use at a width: two blocks per SM at
// 64, one at 128
constexpr int tc_max(int W) { return W == 64 ? tc::kSmemMax : kTcwMax; }

// bytes of one operand buffer of a q x q chain at width W, and of an
// A-side (K, q) patch block (rows padded to 16)
long long op_bytes(int W, bool f32, int q) {
  return f32 ? 4LL * tc::OpTf32::elems(q) : 2LL * W * (W + 8);
}
long long block_bytes(int W, bool f32, int K, int q) {
  return (long long)tc::round_up(K, 16) *
         (f32 ? 4LL * (tc::round_up(q, 8) + 4) : 2LL * (W + 8));
}

// The wide design's width for (K, p) groups (0: not its shape).
int tcw_width(int K, int p, bool f32) {
  if (K < p || p < 1) return 0;
  if (f32) return p <= 64 ? 64 : p <= 128 ? 128 : 0;
  return p > tc::kQ && p <= 128 ? 128 : 0;
}

// Dynamic shared memory of the wide design for (K, p) groups, or 0 when it
// does not take them: the largest of its phases (xc and the covariance's
// scratch; A, T_2, T_3 and two operand buffers; the same, one buffer and
// xn).  ops/econ_filter.py `tcw_smem_bytes` mirrors this.
int tcw_smem(int K, int p, bool f32) {
  const int W = tcw_width(K, p, f32);
  if (W == 0) return 0;
  const long long tsz = (long long)p * tcw_ldt(p) * 4,
                  buf = op_bytes(W, f32, p);
  long long n = (long long)K * (W + 4) * 4 + 2LL * W * (W + 8) * 4;
  if (3 * tsz + 2 * buf > n) n = 3 * tsz + 2 * buf;
  const long long app = 3 * tsz + buf + block_bytes(W, f32, K, p);
  if (app > n) n = app;
  return n <= tc_max(W) ? (int)n : 0;
}

// The wide design's chain, which the streamed Gram route shares: A, the
// fragment of M / K (M the covariance or the Gram), becomes 2 M / (K lub)
// - I; A, T_2 and T_3 go to TA, T2 = TA + q ldt, T3 = T2 + q ldt (f32, q
// rows of ldt floats) for V_i, B = T_s(A) to bB (B side), the Clenshaw
// state through bH (A side); F = sum_i T_i(B) V_i lands in lo.  gam (the
// m x s econ coefficients) is read after the chain's first barrier; ends
// with a barrier, after which every operand buffer and T_r is free.
template <int W, class O>
__device__ __forceinline__ void wide_chain(
    float (&A)[tc::Frag<W, W, tc::Width<W>::kThreads>::N],
    float (&lo)[tc::Frag<W, W, tc::Width<W>::kThreads>::N], float lub,
    int q, int m, int s, const float* gam, float* TA, int ldt,
    typename O::T* bB, typename O::T* bH, const O& op,
    const tc::Frag<W, W, tc::Width<W>::kThreads>& ps) {
  constexpr int NT = tc::Width<W>::kThreads;
  constexpr int N = tc::Frag<W, W, NT>::N;
  float* T2 = TA + q * ldt;
  float* T3 = T2 + q * ldt;

  // elements i, i + 1 (one row, two columns) of a q x q f32 matrix
  auto tget = [&](const float* Tm, int i) -> float2 {
    const int r = ps.row(i), c = ps.col(i);
    if (r >= q || c >= q) return make_float2(0.f, 0.f);
    if (c + 1 < q) return *reinterpret_cast<const float2*>(Tm + r * ldt + c);
    return make_float2(Tm[r * ldt + c], 0.f);
  };
  auto tput = [&](float* Tm, int i, float a, float b) {
    const int r = ps.row(i), c = ps.col(i);
    if (r >= q || c >= q) return;
    if (c + 1 < q)
      *reinterpret_cast<float2*>(Tm + r * ldt + c) = make_float2(a, b);
    else
      Tm[r * ldt + c] = a;
  };
  // V_i = sum_r gam[i, r] T_r(A) at elements k, k + 1
  auto v_at = [&](int i, int k) -> float2 {
    const float* g = gam + i * s;
    const float2 a = tget(TA, k);
    float vx = g[0] * tc::diag(ps, k, q), vy = g[0] * tc::diag(ps, k + 1, q);
    vx = vx + g[1] * a.x;
    vy = vy + g[1] * a.y;
    if (s >= 3) {
      const float2 t = tget(T2, k);
      vx = vx + g[2] * t.x;
      vy = vy + g[2] * t.y;
    }
    if (s == 4) {
      const float2 t = tget(T3, k);
      vx = vx + g[3] * t.x;
      vy = vy + g[3] * t.y;
    }
    return make_float2(vx, vy);
  };

  // A = M * (2 / lub) - I: f32 for V, an operand on both sides
  float H[N];
  const float sc = 2.f / lub;
#pragma unroll
  for (int k = 0; k < N; ++k) A[k] = A[k] * sc - tc::diag(ps, k, q);
#pragma unroll
  for (int k = 0; k < N; k += 2) tput(TA, k, A[k], A[k + 1]);
  op.store_row(bH, ps, [&](int k) { return A[k]; });
  op.store_colT(bB, ps, [&](int k) { return A[k]; });
  __syncthreads();

  // A^2 into H; then B = T_s(A) into bB, T_2 and T_3 into shared memory
  op.template mma_frag<W, W, NT>(H, bH, op.rows, bB);
  __syncthreads();
  if (s == 2) {
    op.store_colT(bB, ps,
                  [&](int k) { return 2.f * H[k] - tc::diag(ps, k, q); });
  } else {
#pragma unroll
    for (int k = 0; k < N; k += 2)
      tput(T2, k, 2.f * H[k] - tc::diag(ps, k, q),
           2.f * H[k + 1] - tc::diag(ps, k + 1, q));
    // st(4 A^2 - 3 I) st(A): T_3 (s = 4) or B (s = 3), into A
    op.store_row(bH, ps, [&](int k) {
      return 4.f * H[k] - 3.f * tc::diag(ps, k, q);
    });
    __syncthreads();
    op.template mma_frag<W, W, NT>(A, bH, op.rows, bB);
    __syncthreads();
    if (s == 3) {
      op.store_colT(bB, ps, [&](int k) { return A[k]; });
    } else {
#pragma unroll
      for (int k = 0; k < N; k += 2) tput(T3, k, A[k], A[k + 1]);
      // A^4 = st(A^2) st(A^2), B = 8 A^4 - 8 A^2 + I
      op.store_row(bH, ps, [&](int k) { return H[k]; });
      op.store_colT(bB, ps, [&](int k) { return H[k]; });
      __syncthreads();
      op.template mma_frag<W, W, NT>(A, bH, op.rows, bB);
      __syncthreads();
      op.store_colT(bB, ps, [&](int k) {
        return 8.f * A[k] - 8.f * H[k] + tc::diag(ps, k, q);
      });
    }
  }

  // Clenshaw in B over i = m-1 .. 1 (the first step has hi = 0)
  float hi[N];
#pragma unroll
  for (int k = 0; k < N; ++k) hi[k] = lo[k] = 0.f;
  for (int i = m - 1; i >= 1; --i) {
    if (i < m - 1) {
      __syncthreads();  // the last product has read bH
      op.store_row(bH, ps, [&](int k) { return hi[k]; });
      __syncthreads();
#pragma unroll
      for (int k = 0; k < N; k += 2) {
        const float2 v = v_at(i, k);
        lo[k] = 0.5f * (v.x - lo[k]);
        lo[k + 1] = 0.5f * (v.y - lo[k + 1]);
      }
      // V_i + 2 hi B - lo
      op.template mma_acc<W, W, NT>(lo, bH, op.rows, bB);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float nw = 2.f * lo[k];
        lo[k] = hi[k];
        hi[k] = nw;
      }
    } else {
#pragma unroll
      for (int k = 0; k < N; k += 2) {
        const float2 v = v_at(i, k);
        hi[k] = v.x;
        hi[k + 1] = v.y;
      }
    }
  }
  // F = V_0 + hi B - lo, into lo
  if (m > 1) {
    __syncthreads();
    op.store_row(bH, ps, [&](int k) { return hi[k]; });
    __syncthreads();
#pragma unroll
    for (int k = 0; k < N; k += 2) {
      const float2 v = v_at(0, k);
      lo[k] = v.x - lo[k];
      lo[k + 1] = v.y - lo[k + 1];
    }
    op.template mma_acc<W, W, NT>(lo, bH, op.rows, bB);
  } else {
#pragma unroll
    for (int k = 0; k < N; k += 2) {
      const float2 v = v_at(0, k);
      lo[k] = v.x;
      lo[k + 1] = v.y;
    }
  }
  __syncthreads();  // every operand and T_r has been read
}

template <int W, class O>
__global__ void __launch_bounds__(tc::Width<W>::kThreads,
                                  tc::Width<W>::kBlocks)
econ_tcw_kernel(const float* __restrict__ xc, const float* __restrict__ xn,
                float* __restrict__ out, int G, int K, int p, int m, int s,
                int nodes, const float* __restrict__ xs,
                const float* __restrict__ proj, float tau, float lub_floor,
                float sb2, float s2, float cwg) {
  constexpr int NT = tc::Width<W>::kThreads, NW = NT / 32;
  constexpr int LDK = W + 4;
  using FS = tc::Frag<W, W, NT>;
  using T = typename O::T;
  constexpr int N = FS::N;
  extern __shared__ __align__(16) unsigned char smraw[];
  __shared__ float fv[kMaxNodes];
  __shared__ float gam[kMaxCoef];
  __shared__ float scal[1];  // lub
  __shared__ float rowpart[W / 32 * W];
  __shared__ float diagv[W];

  const int q = p, ms = m * s, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ldt = tcw_ldt(q), tsz = q * ldt;
  const O op(q);
  float* Xc = reinterpret_cast<float*>(smraw);
  float* part = Xc + K * LDK;
  float* TA = reinterpret_cast<float*>(smraw);  // A, T_2, T_3 (f32)
  T* bB = reinterpret_cast<T*>(TA + 3 * tsz);   // B side: B = T_s(A)
  T* bH = bB + O::elems(q);                     // A side: the state
  const FS ps;
  const float invk = 1.f / (float)K;

  for (int grp = blockIdx.x; grp < G; grp += gridDim.x) {
    const size_t base = (size_t)grp * K * p;
    tc::load_padded<W, NT>(xc + base, K, K, p, [&](int r, int c, float v) {
      Xc[r * LDK + c] = v;
    });
    __syncthreads();

    // covariance, f32 operands, and lub
    float A[N];
    tc::syrk<W, W, NT>(A, Xc, LDK, Xc, LDK, K, part, ps);
#pragma unroll
    for (int k = 0; k < N; ++k) A[k] *= invk;
    tc::frag_lub<W, NT>(A, ps, rowpart, diagv, lub_floor, &scal[0]);
    const float lub = scal[0];

    // transfer values at the scaled Chebyshev nodes, then gam
    for (int n = tid; n < nodes; n += NT) {
      const float lam = (xs[n] + 1.f) * 0.5f * lub;
      const float wg = cwg * sqrtf(tau * lub);
      const float z = (lam - tau) / (wg / 4.4f);
      const float gate = 1.f / (1.f + expf(-z));
      const float lam_s = fmaxf(lam - sb2, 0.f);
      fv[n] = gate * lam_s / (lam_s + s2);
    }
    __syncthreads();
    for (int j = warp; j < ms; j += NW) {
      float acc = 0.f;
      for (int n = lane; n < nodes; n += 32)
        acc = fmaf(fv[n], proj[n * ms + j], acc);
      acc = vnlb::warp_sum(acc);
      if (lane == 0) gam[j] = acc;
    }

    // the chain: F into lo
    float lo[N];
    wide_chain<W, O>(A, lo, lub, q, m, s, gam, TA, ldt, bB, bH, op, ps);

    // out = st(xn) st(F): xn over the state buffer, rows padded to 16
    const int kpad = tc::round_up(K, 16);
    op.store_colT(bB, ps, [&](int k) { return lo[k]; });
    tc::load_padded<W, NT>(xn + base, kpad, K, p, [&](int r, int c, float v) {
      op.put(bH, r, c, v);
    });
    __syncthreads();
    float* o = out + base;
    const int mt = kpad / 16, nt = (p + 7) / 8;
    const tc::Units un(mt, nt, NW);
    for (int u = warp; u < mt * un.ns; u += NW) {
      const int mi = u / un.ns, n_lo = (u - mi * un.ns) * un.nh;
      const int cnt = min(un.nh, nt - n_lo);
      if (cnt <= 0) continue;
      float c[8][4] = {};
      op.mma_rows(c, bH, kpad, 16 * mi, bB, 8 * n_lo, cnt);
      tc::apply_rows(o, K, p, 16 * mi, 8 * n_lo, cnt, c,
                     [&](int, int, float v) { return v; });
    }
    __syncthreads();  // the next group overwrites shared memory
  }
}

// ---- the streamed Gram route ("tcg", econ_tc.cuh) ----
//
// Gram-route groups (q = K < p) with K <= 128 that the width-64 design
// does not take: the joint groups of `couple_channels`, (100, 147), (60,
// 294) and (100, 294), and without poly_bf16 every Gram group with K <=
// 128, (60, 98) among them.  The chain is the wide design's (A, T_2, T_3
// f32 in shared memory, the Clenshaw pair in registers, two operand
// buffers, bf16 or split TF32) at width 64 (K <= 64: 256 threads, two
// blocks per SM) or 128.  No product holds all p columns of a patch block:
// the Gram xc xc^T / K, xn xc^T and the application out[:, chunk] = f0
// xn[:, chunk] + st(t) st(xc[:, chunk]) 2 / (K lub) each stream the blocks
// in chunks of kChunk = 32 columns through two cp.async stages
// (econ_tc.cuh `chunk_copy`: chunk j + 1 is in flight while chunk j is
// used), so shared memory does not grow with p: (100, 294) takes 194,432
// bytes (bf16) or 214,656 (split TF32), (60, 294) 70,272 or 86,656.  The
// Gram and xn xc^T take f32 operands on CUDA cores (`syrk_rows`, each
// thread's sums over all chunks meeting once, `syrk_merge`), as
// polyspec's cast points say; t = st(xn xc^T) st(F) and the application
// run on tensor cores, the application's st(xc) rounded to bf16 from the
// f32 stage in registers (or split, in TF32).  Layout (`tcg_layout`):
// [the two stages of both blocks | syrk_merge's scratch | A, T_2, T_3,
// whichever is largest] [B, the state: two operand buffers].
struct TcgLayout {
  int width, bytes, ops;  // ops: byte offset of the operand buffers
};

TcgLayout tcg_layout(int K, int p, bool f32) {
  TcgLayout L = {0, 0, 0};
  if (K >= p || K < 1 || K > 128) return L;
  const int W = K <= 64 ? 64 : 128;
  const long long stages = 2LL * 2 * tc::kChunk * (W + 4) * 4;
  const long long merge =
      4LL * (W == 64 ? tc::merge_floats<64, 64, 256>()
                     : tc::merge_floats<128, 128, 512>());
  const long long t3 = 3LL * K * tcw_ldt(K) * 4;
  long long r0 = stages > merge ? stages : merge;
  if (t3 > r0) r0 = t3;
  const long long n = r0 + 2 * op_bytes(W, f32, K);
  if (n > tc_max(W)) return L;
  L.width = W;
  L.bytes = (int)n;
  L.ops = (int)r0;
  return L;
}

template <int W, class O>
__global__ void __launch_bounds__(tc::Width<W>::kThreads,
                                  tc::Width<W>::kBlocks)
econ_tcg_kernel(const float* __restrict__ xc, const float* __restrict__ xn,
                float* __restrict__ out, int G, int K, int p, int m, int s,
                int nodes, const float* __restrict__ xs,
                const float* __restrict__ proj, const float* __restrict__ v0,
                float tau, float lub_floor, float sb2, float s2, float cwg,
                int ops_off) {
  constexpr int NT = tc::Width<W>::kThreads, NW = NT / 32;
  constexpr int LDK = W + 4, CH = tc::kChunk;
  constexpr bool kF32 = std::is_same<O, tc::OpTf32>::value;
  using FS = tc::Frag<W, W, NT>;
  using T = typename O::T;
  constexpr int N = FS::N;
  extern __shared__ __align__(16) unsigned char smraw[];
  __shared__ float fv[kMaxNodes];
  __shared__ float gam[kMaxCoef];
  __shared__ float scal[2];  // lub, f0
  __shared__ float rowpart[W / 32 * W];
  __shared__ float diagv[W];

  const int q = K, ms = m * s, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ldt = tcw_ldt(q);
  const int nch = (p + CH - 1) / CH;
  const O op(q);
  float* stage = reinterpret_cast<float*>(smraw);  // [2][xc, xn][CH][LDK]
  float* part = stage;                             // syrk_merge's scratch
  float* TA = stage;                               // A, T_2, T_3 (f32)
  T* bB = reinterpret_cast<T*>(smraw + ops_off);  // B side
  T* bH = bB + O::elems(q);                       // A side
  const FS ps;
  const float invk = 1.f / (float)K;

  // use(j, xc chunk, xn chunk, columns) for the chunks of the group's
  // blocks in order; xn is copied only when both is set.  Begins after a
  // barrier's worth of quiet (the stages are free) and ends with one.
  auto stream = [&](const float* a, const float* b, bool both, auto use) {
    auto fetch = [&](int j) {
      if (j < nch) {
        const int c0 = j * CH, n = min(CH, p - c0);
        float* st = stage + 2 * (j & 1) * CH * LDK;
        tc::chunk_copy<W, NT>(st, LDK, a, K, p, c0, n);
        if (both) tc::chunk_copy<W, NT>(st + CH * LDK, LDK, b, K, p, c0, n);
      }
      tc::cp_async_commit();  // an empty group past the last chunk
    };
    fetch(0);
    for (int j = 0; j < nch; ++j) {
      fetch(j + 1);
      tc::cp_async_wait<1>();
      __syncthreads();
      const float* st = stage + 2 * (j & 1) * CH * LDK;
      use(j, st, st + CH * LDK, min(CH, p - j * CH));
      __syncthreads();  // before chunk j + 2 lands in this stage
    }
  };

  for (int grp = blockIdx.x; grp < G; grp += gridDim.x) {
    const size_t base = (size_t)grp * K * p;
    const float* xcg = xc + base;
    const float* xng = xn + base;

    // Gram xc xc^T / K, f32 operands, streamed; and lub
    float A[N], H[N];
    {
      float acc[8][8] = {};
      stream(xcg, xng, false, [&](int, const float* c, const float*, int n) {
        tc::syrk_rows<W, W, NT>(acc, c, LDK, c, LDK, n);
      });
      tc::syrk_merge<W, W, NT>(A, acc, part, ps);
    }
#pragma unroll
    for (int k = 0; k < N; ++k) A[k] *= invk;
    tc::frag_lub<W, NT>(A, ps, rowpart, diagv, lub_floor, &scal[0]);
    const float lub = scal[0];

    // transfer values at the scaled Chebyshev nodes, then gam and f0
    for (int n = tid; n < nodes; n += NT) {
      const float lam = (xs[n] + 1.f) * 0.5f * lub;
      const float wg = cwg * sqrtf(tau * lub);
      const float z = (lam - tau) / (wg / 4.4f);
      const float gate = 1.f / (1.f + expf(-z));
      const float lam_s = fmaxf(lam - sb2, 0.f);
      fv[n] = gate * lam_s / (lam_s + s2);
    }
    __syncthreads();
    for (int j = warp; j < ms + 1; j += NW) {
      float acc = 0.f;
      for (int n = lane; n < nodes; n += 32)
        acc = fmaf(fv[n], j < ms ? proj[n * ms + j] : v0[n], acc);
      acc = vnlb::warp_sum(acc);
      if (lane == 0) (j < ms ? gam[j] : scal[1]) = acc;
    }

    // the chain: F into lo
    float lo[N];
    wide_chain<W, O>(A, lo, lub, q, m, s, gam, TA, ldt, bB, bH, op, ps);

    // mh = xn xc^T (f32, streamed), t = st(mh) st(F)
    op.store_colT(bB, ps, [&](int k) { return lo[k]; });
    {
      float acc[8][8] = {};
      stream(xcg, xng, true,
             [&](int, const float* c, const float* nn, int n) {
               tc::syrk_rows<W, W, NT>(acc, nn, LDK, c, LDK, n);
             });
      tc::syrk_merge<W, W, NT>(H, acc, part, ps);
    }
    op.store_row(bH, ps, [&](int k) { return H[k]; });
    __syncthreads();
    op.template mma_frag<W, W, NT>(A, bH, op.rows, bB);
    __syncthreads();
    op.store_row(bH, ps, [&](int k) { return A[k]; });

    // out[:, chunk] = f0 xn[:, chunk] + st(t) st(xc[:, chunk]) 2/(K lub),
    // in rows of m16n8 tiles over the warps (streamed)
    const float yscale = 2.f / ((float)K * lub), f0 = scal[1];
    const int kpad = tc::round_up(K, 16), mt = kpad / 16;
    const tc::Units un(mt, CH / 8, NW);
    float* o = out + base;
    stream(xcg, xng, true,
           [&](int j, const float* c, const float* nn, int n) {
      const int c0 = j * CH, nt = (n + 7) / 8;
      for (int u = warp; u < mt * un.ns; u += NW) {
        const int mi = u / un.ns, n_lo = (u - mi * un.ns) * un.nh;
        const int cnt = min(un.nh, nt - n_lo);
        if (cnt <= 0) continue;
        float acc[8][4] = {};
        if constexpr (kF32)
          tc::mma_rows_x3(acc, bH, op.ld, op.rows, 16 * mi, c, LDK,
                          8 * n_lo, cnt, op.kt8);
        else
          tc::mma_rows_bf16_f32b(acc, bH, O::ld, 16 * mi, c, LDK, 8 * n_lo,
                                 cnt, kpad / 16);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          if (jj >= cnt) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 16 * mi + (lane >> 2) + 8 * (e >> 1);
            const int col = 8 * (n_lo + jj) + 2 * (lane & 3) + (e & 1);
            if (r < K && col < n)
              o[r * p + c0 + col] =
                  f0 * nn[col * LDK + r] + acc[jj][e] * yscale;
          }
        }
      }
    });
  }
}

}  // namespace

// Workspace floats one launch needs (0 when a group fits shared memory),
// or minus a cudaError_t.
extern "C" long long vnlb_econ_filter_ws(int G, int K, int p) {
  const vnlb::SlotPlan pl = econ_plan(K, p);
  int grid = 0;
  const int err = vnlb::plan_grid((const void*)pick_kernel(pl), kThreads,
                                  pl, G, &grid);
  if (err != 0) return -(long long)err;
  return pl.ws_floats * (long long)grid;
}

// xc, xn, out: (G, K, p) f32 contiguous.  xs: (nodes,) Chebyshev nodes;
// proj: (nodes, m*s) node values -> econ coefficients; v0: (nodes,) node
// values -> f(-1) for the Gram route, null for the matrix route.  ws: the
// workspace of vnlb_econ_filter_ws floats (null when that is 0).
extern "C" int vnlb_econ_filter(const float* xc, const float* xn, float* out,
                                int G, int K, int p, int m, int s, int nodes,
                                const float* xs, const float* proj,
                                const float* v0, float tau, float lub_floor,
                                float sb2, float s2, float cwg, int rnd,
                                float* ws, void* stream) {
  if (G <= 0) return 0;
  if (nodes > kMaxNodes || m * s > kMaxCoef || s < 2 || s > 4)
    return (int)cudaErrorInvalidValue;
  const vnlb::SlotPlan pl = econ_plan(K, p);
  if (pl.ws_floats > 0 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const EconKernel kernel = pick_kernel(pl);
  int grid = 0;
  const int err = vnlb::plan_grid((const void*)kernel, kThreads, pl, G,
                                  &grid);
  if (err != 0) return err;
  kernel<<<grid, kThreads, pl.smem_floats * sizeof(float),
           (cudaStream_t)stream>>>(
      xc, xn, out, G, K, p, m, s, nodes, xs, proj, v0, tau, lub_floor, sb2,
      s2, cwg, rnd, pl, ws);
  return (int)cudaGetLastError();
}


// Dynamic shared memory of the tensor-core design for (K, p) groups (0:
// the design does not take them), and the blocks it keeps on one SM (0
// when it does not take them); returns a cudaError_t.
extern "C" int vnlb_econ_filter_tc_plan(int K, int p, int* smem,
                                        int* per_sm) {
  *smem = tc_smem(K, p);
  *per_sm = 0;
  if (*smem == 0) return 0;
  int grid = 0;
  return tc_grid(1, *smem, &grid, per_sm);
}

// The tensor-core design on (G, K, p) groups under poly_bf16 (arguments as
// vnlb_econ_filter's); cudaErrorInvalidValue for a shape it does not take.
extern "C" int vnlb_econ_filter_tc(const float* xc, const float* xn,
                                   float* out, int G, int K, int p, int m,
                                   int s, int nodes, const float* xs,
                                   const float* proj, const float* v0,
                                   float tau, float lub_floor, float sb2,
                                   float s2, float cwg, void* stream) {
  if (G <= 0) return 0;
  const int smem = tc_smem(K, p);
  if (smem == 0 || nodes > kMaxNodes || m * s > kMaxCoef || s < 2 || s > 4)
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  const int err = tc_grid(G, smem, &grid, nullptr);
  if (err != 0) return err;
  econ_tc_kernel<<<grid, tc::kThreads, smem, (cudaStream_t)stream>>>(
      xc, xn, out, G, K, p, m, s, nodes, xs, proj, v0, tau, lub_floor, sb2,
      s2, cwg, smem);
  return (int)cudaGetLastError();
}

namespace {

// The wide design's and the streamed Gram route's kernels: bf16 operands
// (rnd) or split TF32, at width 64 or 128 (each design's instantiations
// share one signature).
using TcwKernel = decltype(&econ_tcw_kernel<128, tc::OpBf16<128>>);
using TcgKernel = decltype(&econ_tcg_kernel<128, tc::OpBf16<128>>);

TcwKernel tcw_kernel(int W, bool f32) {
  if (!f32) return &econ_tcw_kernel<128, tc::OpBf16<128>>;
  return W == 64 ? &econ_tcw_kernel<64, tc::OpTf32>
                 : &econ_tcw_kernel<128, tc::OpTf32>;
}
TcgKernel tcg_kernel(int W, bool f32) {
  if (W == 64)
    return f32 ? &econ_tcg_kernel<64, tc::OpTf32>
               : &econ_tcg_kernel<64, tc::OpBf16<64>>;
  return f32 ? &econ_tcg_kernel<128, tc::OpTf32>
             : &econ_tcg_kernel<128, tc::OpBf16<128>>;
}
int threads_of(int W) {
  return W == 64 ? tc::Width<64>::kThreads : tc::Width<128>::kThreads;
}

// (dynamic shared memory, blocks per SM) of a kernel, both 0 when smem is
// 0 (the design does not take the shape); returns a cudaError_t
int plan_of(const void* kernel, int W, int smem_, int* smem, int* per_sm) {
  *smem = smem_;
  *per_sm = 0;
  if (smem_ == 0) return 0;
  int grid = 0;
  return tc::occupancy_grid(kernel, threads_of(W), smem_, 1, &grid, per_sm);
}

}  // namespace

// Dynamic shared memory of the wide tensor-core design for (K, p) groups
// (bf16 operands when rnd, else split TF32) and the blocks it keeps on one
// SM (both 0 when it does not take them); returns a cudaError_t.
extern "C" int vnlb_econ_filter_tcw_plan(int K, int p, int rnd, int* smem,
                                         int* per_sm) {
  const int W = tcw_width(K, p, !rnd);
  return plan_of(W ? (const void*)tcw_kernel(W, !rnd) : nullptr, W,
                 tcw_smem(K, p, !rnd), smem, per_sm);
}

// The wide tensor-core design on (G, K, p) matrix-route groups (arguments
// as vnlb_econ_filter's, no v0); cudaErrorInvalidValue for a shape it
// does not take.
extern "C" int vnlb_econ_filter_tcw(const float* xc, const float* xn,
                                    float* out, int G, int K, int p, int m,
                                    int s, int nodes, const float* xs,
                                    const float* proj, float tau,
                                    float lub_floor, float sb2, float s2,
                                    float cwg, int rnd, void* stream) {
  if (G <= 0) return 0;
  const bool f32 = !rnd;
  const int smem = tcw_smem(K, p, f32), W = tcw_width(K, p, f32);
  if (smem == 0 || nodes > kMaxNodes || m * s > kMaxCoef || s < 2 || s > 4)
    return (int)cudaErrorInvalidValue;
  const TcwKernel kernel = tcw_kernel(W, f32);
  int grid = 0;
  const int err = tc::occupancy_grid((const void*)kernel, threads_of(W),
                                     smem, G, &grid, nullptr);
  if (err != 0) return err;
  kernel<<<grid, threads_of(W), smem, (cudaStream_t)stream>>>(
      xc, xn, out, G, K, p, m, s, nodes, xs, proj, tau, lub_floor, sb2, s2,
      cwg);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the streamed Gram route for (K, p) groups
// (bf16 operands when rnd, else split TF32) and the blocks it keeps on one
// SM (both 0 when it does not take them); returns a cudaError_t.
extern "C" int vnlb_econ_filter_tcg_plan(int K, int p, int rnd, int* smem,
                                         int* per_sm) {
  const TcgLayout L = tcg_layout(K, p, !rnd);
  return plan_of(L.width ? (const void*)tcg_kernel(L.width, !rnd) : nullptr,
                 L.width, L.bytes, smem, per_sm);
}

// The streamed Gram route on (G, K, p) groups with K < p (arguments as
// vnlb_econ_filter's, with v0); cudaErrorInvalidValue for a shape it does
// not take.
extern "C" int vnlb_econ_filter_tcg(const float* xc, const float* xn,
                                    float* out, int G, int K, int p, int m,
                                    int s, int nodes, const float* xs,
                                    const float* proj, const float* v0,
                                    float tau, float lub_floor, float sb2,
                                    float s2, float cwg, int rnd,
                                    void* stream) {
  if (G <= 0) return 0;
  const bool f32 = !rnd;
  const TcgLayout L = tcg_layout(K, p, f32);
  if (L.width == 0 || v0 == nullptr || nodes > kMaxNodes ||
      m * s > kMaxCoef || s < 2 || s > 4)
    return (int)cudaErrorInvalidValue;
  const TcgKernel kernel = tcg_kernel(L.width, f32);
  int grid = 0;
  const int err = tc::occupancy_grid((const void*)kernel, threads_of(L.width),
                                     L.bytes, G, &grid, nullptr);
  if (err != 0) return err;
  kernel<<<grid, threads_of(L.width), L.bytes, (cudaStream_t)stream>>>(
      xc, xn, out, G, K, p, m, s, nodes, xs, proj, v0, tau, lub_floor, sb2,
      s2, cwg, L.ops);
  return (int)cudaGetLastError();
}
