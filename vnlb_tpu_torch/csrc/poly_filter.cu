// K5: the two-factor polynomial spectral filter, one patch group per block.
//
// Replaces the Pallas kernel vnlb_tpu/ops/pallas_poly.py:50 (`_poly_kernel`,
// launched at pallas_poly.py:153 by `poly_filter_pallas` :125, the
// `poly_impl="pallas"` route), whose function is vnlb_tpu/ops/polyspec.py
// `poly_filter` (:96-190), the route `poly_econ=False` also takes.  Per
// group (xc, xn: K x p centred patches):
//   C   = xc^T xc / K                                 (f32 operands)
//   lub = max(min(trace C, max row |sum|), 1.5 tau) * 1.02
//   S   = st((C - tau I) / max(lub - tau, tau)), then n_aggr quintic steps
//         S2 = st(S S), S3 = S2 S, S5 = S2 st(S3),
//         S  = st(a S + b S3 + c S5)
//         and n_polish cubic steps S = st(1.5 S - 0.5 S st(S S));
//   W   = (S + I) / 2                                 (the sign gate)
//   coef = wiener(lam at the Chebyshev nodes scaled to [0, lub]) @ DCT
//   Ah  = st(2 C / lub - I)
//   K >= p (right): Q = sum_j coef_j T_j(Ah), F = st(W) st(Q),
//                   out = xn st(F)
//   K <  p (left):  z_0 = xn W, z_1 = st(z_0) Ah,
//                   z_j = 2 st(z_{j-1}) Ah - z_{j-2}, out = sum coef_j z_j
// `st` is bf16 storage rounding when `rnd`; the cast points are polyspec's
// (the Pallas kernel rounds every product operand instead): products of
// bf16-rounded operands are exact in f32 and summed with fmaf.
//
// What bounds it on the H100: arithmetic.  A stage-1 group (K=60, p=98)
// reads 2 x 23.5 KB, writes 23.5 KB and does ~20 M multiply-adds (15 p^3
// in the gate, 8 K p^2 in the recurrence, 2 K p^2 in f32), ~280 per byte;
// a stage-0 group (K=100, p=49) ~3.2 M.  The gate is 15 dependent p x p
// products.  The simple design runs every product of the group in one
// block on CUDA cores with the 2x2 register tiles of K2 (group_mm.cuh),
// with the five p x p buffers (Ah, S / W and three products) and the
// patch blocks placed in shared memory by priority.  The accumulator of
// either route (Q, p x p <= K x p, or the K x p sum) lives in the group's
// own output rows, so at (60, 98) and (100, 98) only the xn block is read
// in place from device memory and no workspace is needed; larger p (the
// joint groups of `couple_channels`) spill p x p buffers to a per-block
// workspace under a persistent grid, as in K2.  Tensor cores (wgmma) are a
// later change.

#include "group_mm.cuh"

namespace {

using vnlb::block_mm;
using vnlb::mm_r;

constexpr int kThreads = 512;
constexpr int kMaxNodes = 128;
constexpr int kMaxCoef = 64;

// buffers in placement priority: Ah, S (then W), three product buffers
// (the gate's S2, S3, S5; then T_{j-1}, T_j, product or z_{j-1}, z_j,
// product), then the xc and xn patch blocks
enum { kAh, kS, kB1, kB2, kB3, kXc, kXn, kSlots };

vnlb::SlotPlan poly_plan(int K, int p) {
  const long long pp = (long long)p * p, kp = (long long)K * p;
  const long long floats[kSlots] = {pp, pp, pp, pp, pp, kp, kp};
  const bool input[kSlots] = {false, false, false, false, false, true, true};
  return vnlb::plan_slots(kSlots, floats, input);
}

__device__ __forceinline__ float eye(int e, int p) {
  const int i = e / p;
  return e - i * p == i ? 1.f : 0.f;
}

template <bool kSh, bool kInSh>
__global__ void __launch_bounds__(kThreads)
poly_filter_kernel(const float* __restrict__ xc, const float* __restrict__ xn,
                   float* out, int G, int K, int p, int n_aggr, int n_polish,
                   int wdeg, int nodes, const float* __restrict__ xs,
                   const float* __restrict__ dct, float tau, float sb2,
                   float s2, float qa, float qb, float qc, int rnd,
                   vnlb::SlotPlan pl, float* ws) {
  extern __shared__ float sm[];
  __shared__ float wv[kMaxNodes];
  __shared__ float coef[kMaxCoef];
  __shared__ float scal[1];  // lub

  const int kp = K * p, pp = p * p, nc = wdeg + 1;
  const int tid = threadIdx.x;
  float* wsb = ws == nullptr ? nullptr : ws + blockIdx.x * pl.ws_floats;
  float* Ah = vnlb::slot<kSh>(pl, kAh, sm, wsb);
  float* S = vnlb::slot<kSh>(pl, kS, sm, wsb);
  float* B1 = vnlb::slot<kSh>(pl, kB1, sm, wsb);
  float* B2 = vnlb::slot<kSh>(pl, kB2, sm, wsb);
  float* B3 = vnlb::slot<kSh>(pl, kB3, sm, wsb);
  float* Xc_s = vnlb::slot<kInSh>(pl, kXc, sm, wsb);
  float* Xn_s = vnlb::slot<kInSh>(pl, kXn, sm, wsb);
  const bool r16 = rnd != 0;
  const float invk = 1.f / (float)K;
  auto st = [r16](float x) { return r16 ? vnlb::rbf(x) : x; };

  for (int grp = blockIdx.x; grp < G; grp += gridDim.x) {
    const size_t base = (size_t)grp * kp;
    float* o = out + base;
    const float *X1, *X2;
    vnlb::load_inputs<kInSh>(pl, kXc, kXn, Xc_s, Xn_s, xc + base, xn + base,
                             kp, &X1, &X2);
    __syncthreads();

    // covariance C into B1, f32 operands
    block_mm<true, false, false, false, false>(B1, p, X1, p, X1, p, p, K, p,
                                               1.f, 0.f, invk, nullptr, 0.f);
    __syncthreads();
    vnlb::spectral_bound(B1, p, B2, 1.5f * tau, &scal[0]);
    const float lub = scal[0];

    // S = st((C - tau I) / sc) and Ah = st(2 C / lub - I); the Wiener
    // factor's node values
    const float sc = fmaxf(lub - tau, tau);
    for (int e = tid; e < pp; e += blockDim.x) {
      const float c = B1[e], d = eye(e, p);
      S[e] = st((c - tau * d) / sc);
      Ah[e] = st(2.f * c / lub - d);
    }
    for (int n = tid; n < nodes; n += blockDim.x) {
      const float lam = (xs[n] + 1.f) * 0.5f * lub;
      const float lc = fmaxf(lam, 0.9f * tau);
      wv[n] = (lc - sb2) / (lc - sb2 + s2);
    }
    __syncthreads();
    for (int j = tid; j < nc; j += blockDim.x) {
      float acc = 0.f;
      for (int n = 0; n < nodes; ++n) acc = fmaf(wv[n], dct[n * nc + j], acc);
      coef[j] = acc;
    }

    // matrix sign gate
    for (int it = 0; it < n_aggr; ++it) {
      mm_r(B1, p, S, p, S, p, p, p, p, r16);    // S2 (rounded at use)
      __syncthreads();
      mm_r(B2, p, B1, p, S, p, p, p, p, r16);   // S3
      __syncthreads();
      mm_r(B3, p, B1, p, B2, p, p, p, p, r16);  // S5 = S2 st(S3)
      __syncthreads();
      for (int e = tid; e < pp; e += blockDim.x)
        S[e] = st(qa * S[e] + qb * B2[e] + qc * B3[e]);
      __syncthreads();
    }
    for (int it = 0; it < n_polish; ++it) {
      mm_r(B1, p, S, p, S, p, p, p, p, r16);
      __syncthreads();
      mm_r(B2, p, S, p, B1, p, p, p, p, r16);
      __syncthreads();
      for (int e = tid; e < pp; e += blockDim.x)
        S[e] = st(1.5f * S[e] - 0.5f * B2[e]);
      __syncthreads();
    }
    for (int e = tid; e < pp; e += blockDim.x)
      S[e] = 0.5f * (S[e] + eye(e, p));  // W, f32
    __syncthreads();

    if (K >= p) {
      // right: Q (in the group's output rows, p x p) = sum_j coef_j T_j(Ah)
      float* tp = B1;
      float* tc = B2;
      for (int e = tid; e < pp; e += blockDim.x) {
        const float d = eye(e, p);
        tp[e] = d;
        tc[e] = Ah[e];
        o[e] = coef[0] * d + coef[1] * Ah[e];
      }
      __syncthreads();
      for (int j = 2; j <= wdeg; ++j) {
        mm_r(B3, p, Ah, p, tc, p, p, p, p, r16);
        __syncthreads();
        for (int e = tid; e < pp; e += blockDim.x) {
          const float tn = 2.f * B3[e] - tp[e];
          o[e] = o[e] + coef[j] * tn;
          tp[e] = tn;
        }
        __syncthreads();
        float* t = tp;
        tp = tc;
        tc = t;
      }
      // F = st(W) st(Q), then out = xn st(F) over Q's rows
      mm_r(B3, p, S, p, o, p, p, p, p, r16);
      __syncthreads();
      if (r16)
        block_mm<false, false, false, true, false>(o, p, X2, p, B3, p, K, p,
                                                   p, 1.f, 0.f, 1.f, nullptr,
                                                   0.f);
      else
        mm_r(o, p, X2, p, B3, p, K, p, p, false);
    } else {
      // left: z_0 = xn W (f32), z_1 = st(z_0) Ah, the sum in the output
      block_mm<false, false, false, false, false>(B1, p, X2, p, S, p, K, p, p,
                                                  1.f, 0.f, 1.f, nullptr,
                                                  0.f);
      __syncthreads();
      mm_r(B2, p, B1, p, Ah, p, K, p, p, r16);
      __syncthreads();
      float* zp = B1;
      float* zc = B2;
      for (int e = tid; e < kp; e += blockDim.x)
        o[e] = coef[0] * zp[e] + coef[1] * zc[e];
      for (int j = 2; j <= wdeg; ++j) {
        mm_r(B3, p, zc, p, Ah, p, K, p, p, r16);
        __syncthreads();
        for (int e = tid; e < kp; e += blockDim.x) {
          const float zn = 2.f * B3[e] - zp[e];
          o[e] = o[e] + coef[j] * zn;
          zp[e] = zn;
        }
        __syncthreads();
        float* t = zp;
        zp = zc;
        zc = t;
      }
    }
    __syncthreads();  // the next group overwrites the slots
  }
}

// The instantiation for a plan: shared-memory pointers where the plan
// keeps every scratch buffer (and both patch blocks) in shared memory.
using PolyKernel = decltype(&poly_filter_kernel<true, true>);

PolyKernel pick_kernel(const vnlb::SlotPlan& pl) {
  if (!vnlb::scratch_shared(pl)) return &poly_filter_kernel<false, false>;
  if (!vnlb::inputs_shared(pl, kXc, kXn))
    return &poly_filter_kernel<true, false>;
  return &poly_filter_kernel<true, true>;
}

}  // namespace

// Workspace floats one launch needs (0 when a group fits shared memory),
// or minus a cudaError_t.
extern "C" long long vnlb_poly_filter_ws(int G, int K, int p) {
  const vnlb::SlotPlan pl = poly_plan(K, p);
  int grid = 0;
  const int err = vnlb::plan_grid((const void*)pick_kernel(pl), kThreads,
                                  pl, G, &grid);
  if (err != 0) return -(long long)err;
  return pl.ws_floats * (long long)grid;
}

// xc, xn, out: (G, K, p) f32 contiguous.  xs: (nodes,) Chebyshev nodes;
// dct: (nodes, wdeg+1) node values -> Chebyshev coefficients; (qa, qb, qc)
// the quintic sign step.  ws: vnlb_poly_filter_ws floats (null when 0).
extern "C" int vnlb_poly_filter(const float* xc, const float* xn, float* out,
                                int G, int K, int p, int n_aggr, int n_polish,
                                int wdeg, int nodes, const float* xs,
                                const float* dct, float tau, float sb2,
                                float s2, float qa, float qb, float qc,
                                int rnd, float* ws, void* stream) {
  if (G <= 0) return 0;
  if (nodes > kMaxNodes || wdeg + 1 > kMaxCoef || wdeg < 1)
    return (int)cudaErrorInvalidValue;
  const vnlb::SlotPlan pl = poly_plan(K, p);
  if (pl.ws_floats > 0 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const PolyKernel kernel = pick_kernel(pl);
  int grid = 0;
  const int err = vnlb::plan_grid((const void*)kernel, kThreads, pl, G,
                                  &grid);
  if (err != 0) return err;
  kernel<<<grid, kThreads, pl.smem_floats * sizeof(float),
           (cudaStream_t)stream>>>(
      xc, xn, out, G, K, p, n_aggr, n_polish, wdeg, nodes, xs, dct, tau, sb2,
      s2, qa, qb, qc, rnd, pl, ws);
  return (int)cudaGetLastError();
}
