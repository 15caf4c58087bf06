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
// byte; the chain is seven dependent q x q products.  The simple design
// keeps the group's two patch blocks and seven q x q f32 matrices in
// shared memory when they fit (~148 KB at stage 1, ~106 KB at stage 0 of
// the iphone preset), reads each input once and writes the output once;
// the products (group_mm.cuh) run on CUDA cores with a 2x2 tile of
// outputs per thread, rounding operands to bf16 in registers and
// accumulating with fmaf.  Tensor cores (wgmma) are a later change.
//
// Groups beyond shared memory: the presets with pt=2 in the first pass
// (K=100, p=98: 347 KB) and `couple_channels` (p = 3 x 49 or 3 x 98; up to
// 515 KB) do not fit the 227 KB a block may use.  Of the two designs that
// keep the arithmetic as it is, this kernel takes the one that changes no
// cast point: the buffers are placed by priority (group_mm.cuh
// `plan_slots`), the most-read q x q matrices first, the patch blocks
// last; a matrix that does not fit lives in the block's slice of a
// workspace in device memory, and a patch block that does not fit is read
// in place from the input.  The spilled matrices are the Clenshaw state
// and T_3, each touched once per chain step, and the patch blocks are read
// by one product each.  A spilling launch runs a persistent grid of one
// block per resident slot (132 at one block per SM), so the workspace is
// 132 x 2 q^2 floats (10 MB at q=98), which stays in L2; storing matrices
// in bf16 instead would not make room (seven f32 q x q at q=98 are
// already 269 KB, and A and T_3 are read in f32 by the Clenshaw sums).

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
