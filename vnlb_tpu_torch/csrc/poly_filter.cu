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
// products.  Three designs (ops/poly_filter.py `design`); two here, the
// batched one in poly_tcb.cu:
//
// The tensor-core design (`poly_tc_kernel<W, Op>`, econ_tc.cuh) takes every
// shape with p <= 128 whose buffers fit (ops/poly_filter.py
// `tc_smem_bytes`; the left route needs K <= 64): p is padded to W = 64
// (256 threads, two blocks per SM: the right route's (100, 49)) or W = 128
// (512 threads, one block per SM: the left route's (60, 98)).  Every p x p
// product of the chain and of the applications is a padded W x W
// mma.sync with f32 accumulation.  Under poly_bf16 (`OpBf16`) each operand
// goes to shared memory once, rounded to bf16 when it is stored, which is
// polyspec's `st`, so the cast points stay where they are.  Without it
// (`OpTf32`) the operands are stored in f32 and every product is three
// TF32 mma of operands split in registers (econ_tc.cuh); the f32 operand
// buffers hold round_up(p, 8) rows of round_up(p, 8) + 4 floats, so the
// gate's five at p = 98 take 5 x 104 x 108 x 4 = 224,640 of the 225,280
// bytes a width-128 block is given (padded to 128 rows they would not
// fit).  The f32 state (the gate's S^3 and S^5, the T_j pair, the z_j pair
// and their sum) lives in the accumulator registers of the thread that
// computed it; the right route keeps Q in shared memory in f32: under bf16
// after the four operand buffers, one column per thread (W x W floats); in
// split TF32 in the fifth operand buffer, which the gate leaves dead, at
// its own layout (round_up(p, 8) rows of round_up(p, 8) + 4 floats, the
// square that store_colT reads), so that the right route at p = 98 needs
// no more than the gate's 224,640 bytes (W x W floats after four buffers
// would take 245,248).
// The covariance and the left route's z_0 = xn W take f32 operands and
// run on CUDA cores (econ_tc.cuh `syrk`); the right route's out = xn st(F)
// takes xn in f32, as three bf16 parts (hi + mid + lo = xn exactly),
// three tensor-core products summed in f32, or in split TF32.  The shared
// memory is time-shared by phase: the xc block and the covariance's
// scratch, then the five gate buffers (Ah, S on both sides, S^2, S^3),
// then the route's own (right: T_j on the B side twice, Q, then xn; left:
// xn^T, W in f32 and the xn W scratch, then z_j on the A side twice), so
// xc is read at the start and xn once near the end.  Zero padding is
// exact for this function (vnlb_tpu/ops/pallas_poly.py:22-27): the pad
// block of every matrix stays zero and I is I_p.
//
// The batched design (poly_tcb.cu) takes the left routes the tensor-core
// design does not: the joint groups of `couple_channels` (p = 147, 294),
// whose gate chain needs five or more p x p matrices (1.3 MB at p = 294
// in bf16, beyond one SM), left routes with K > 64 and p > 128; every p x
// p product is one launch over many blocks, through a device workspace.
//
// The shared-memory design (`poly_filter_kernel`) takes the rest, the
// right routes whose buffers do not fit one tensor-core block: p = 128 in
// split TF32 (ps = 8, pt = 2 with npatches >= 128) and xc of more rows
// than the covariance phase holds (npatches = 300 at p = 49, K > 162 at p
// = 98); no preset reaches them.  It is also the comparison the card's
// checks time beside the other two (`smem_design`).  Every product on
// CUDA cores with the 2x2 register tiles of K2 (group_mm.cuh), with the
// five p x p buffers (Ah, S / W and three products) and the patch blocks
// placed in shared memory by priority.  The accumulator of either route
// (Q, p x p <= K x p, or the K x p sum) lives in the group's own output
// rows; p x p buffers beyond shared memory spill to a per-block workspace
// under a persistent grid, as in K2.

#include <type_traits>

#include "econ_tc.cuh"
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


// ---- the tensor-core design (econ_tc.cuh) ----

namespace tc = vnlb::tc;
using bf16 = __nv_bfloat16;

// dynamic shared memory a block may use at each width: two blocks per SM
// at 64, one at 128 (227 KB less the static tables)
constexpr int kTcMax64 = 104 * 1024, kTcMax128 = 220 * 1024;

__host__ __device__ inline long long lmax(long long a, long long b) {
  return a > b ? a : b;
}

// Where the tensor-core design keeps a group's buffers (byte offsets into
// dynamic shared memory; see the note at the top).  width 0: the design
// does not take (K, p).  ops/poly_filter.py `tc_smem_bytes` mirrors
// `bytes`.
struct TcLayout {
  int width, bytes, f32;
  int part1;             // the covariance's syrk scratch, after xc
  int xnt, wf, part3;    // left: xn^T, W (f32), the xn W syrk scratch
  int qs;                // right under bf16: Q, f32, one column per thread
};

__host__ __device__ inline TcLayout tc_layout(int K, int p, bool f32) {
  TcLayout L = {0, 0, 0, 0, 0, 0, 0, 0};
  const int W = p <= 64 ? 64 : p <= 128 ? 128 : 0;
  if (W == 0 || K < 1 || p < 1 || (K < p && K > 64)) return L;
  // an operand buffer and a row of one: bf16 at W + 8, or f32 at ld
  const long long ldb = W + 8, ldk = W + 4;
  const long long row = f32 ? 4LL * (tc::round_up(p, 8) + 4) : 2 * ldb;
  const long long buf = f32 ? 4LL * tc::OpTf32::elems(p) : W * ldb * 2;
  L.part1 = (int)(K * ldk * 4);
  long long n = lmax(L.part1 + 2LL * W * (W + 8) * 4, 5 * buf);
  if (K < p) {
    L.xnt = (int)buf;
    L.wf = L.xnt + p * 68 * 4;
    L.part3 = (int)(L.wf + p * ldk * 4);
    n = lmax(n, L.part3 + 2LL * 64 * (W + 8) * 4);
    n = lmax(n, buf + 2 * 64 * row);  // z_j on the A side by turns
  } else {
    // Q after four buffers under bf16; in split TF32 in the fifth
    if (!f32) {
      L.qs = (int)(4 * buf);
      n = lmax(n, L.qs + (long long)W * W * 4);
    }
    // xn: three bf16 parts, or f32
    n = lmax(n, buf + (f32 ? 1 : 3) * tc::round_up(K, 16) * row);
  }
  if (n > (W == 64 ? kTcMax64 : kTcMax128)) return L;
  L.width = W;
  L.bytes = (int)n;
  L.f32 = f32;
  return L;
}

template <int W, class O>
__global__ void __launch_bounds__(tc::Width<W>::kThreads,
                                  tc::Width<W>::kBlocks)
poly_tc_kernel(const float* __restrict__ xc, const float* __restrict__ xn,
               float* __restrict__ out, int G, int K, int p, int n_aggr,
               int n_polish, int wdeg, int nodes,
               const float* __restrict__ xs, const float* __restrict__ dct,
               float tau, float sb2, float s2, float qa, float qb, float qc,
               TcLayout L) {
  constexpr int NT = tc::Width<W>::kThreads, NW = NT / 32;
  constexpr int LDK = W + 4, LDX = 64 + 4;
  constexpr bool kF32 = std::is_same<O, tc::OpTf32>::value;
  using FS = tc::Frag<W, W, NT>;   // p x p matrices
  using FZ = tc::Frag<64, W, NT>;  // the left route's K x p states
  using T = typename O::T;
  constexpr int NS = FS::N, NZ = FZ::N;
  extern __shared__ __align__(16) unsigned char smraw[];
  __shared__ float wv[kMaxNodes];
  __shared__ float coef[kMaxCoef];
  __shared__ float scal[1];  // lub
  __shared__ float rowpart[W / 32 * W];
  __shared__ float diagv[W];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kp = K * p, nc = wdeg + 1;
  const bool left = K < p;
  const O op(p);
  const int E = O::elems(p);  // elements of one operand buffer
  float* Xc = reinterpret_cast<float*>(smraw);
  float* part1 = reinterpret_cast<float*>(smraw + L.part1);
  T* Ah = reinterpret_cast<T*>(smraw);  // A side (right), B (left)
  T* S_row = Ah + E;
  T* S_colT = S_row + E;
  T* S2_row = S_colT + E;
  T* S3_colT = S2_row + E;
  const FS ps;
  const FZ pz;
  const float invk = 1.f / (float)K;
  // the thread's own element i of a row-layout buffer, as f32
  auto own = [&](const T* buf, int i) {
    return op.get(buf, ps.row(i), ps.col(i));
  };

  for (int grp = blockIdx.x; grp < G; grp += gridDim.x) {
    const size_t base = (size_t)grp * kp;
    float* o = out + base;
    tc::load_padded<W, NT>(xc + base, K, K, p, [&](int r, int c, float v) {
      Xc[r * LDK + c] = v;
    });
    __syncthreads();

    // covariance C, f32 operands, and lub
    float C[NS];
    tc::syrk<W, W, NT>(C, Xc, LDK, Xc, LDK, K, part1, ps);
#pragma unroll
    for (int i = 0; i < NS; ++i) C[i] *= invk;
    tc::frag_lub<W, NT>(C, ps, rowpart, diagv, 1.5f * tau, &scal[0]);
    const float lub = scal[0];

    // the Wiener factor's node values, then its Chebyshev coefficients
    for (int n = tid; n < nodes; n += NT) {
      const float lam = (xs[n] + 1.f) * 0.5f * lub;
      const float lc = fmaxf(lam, 0.9f * tau);
      wv[n] = (lc - sb2) / (lc - sb2 + s2);
    }
    __syncthreads();
    for (int j = warp; j < nc; j += NW) {
      float acc = 0.f;
      for (int n = lane; n < nodes; n += 32)
        acc = fmaf(wv[n], dct[n * nc + j], acc);
      acc = vnlb::warp_sum(acc);
      if (lane == 0) coef[j] = acc;
    }

    // S = st((C - tau I) / sc) on both sides; Ah = st(2 C / lub - I),
    // each division a product with the reciprocal (within an ulp of the
    // quotient before the bf16 rounding; IEEE division per element costs
    // a tenth of the gate and takes a slow path on the pad block's zeros)
    const float rsc = 1.f / fmaxf(lub - tau, tau), rlub = 2.f / lub;
    float P[NS], R[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float d = tc::diag(ps, i, p);
      P[i] = (C[i] - tau * d) * rsc;
      R[i] = C[i] * rlub - d;
    }
    op.store_row(S_row, ps, [&](int i) { return P[i]; });
    op.store_colT(S_colT, ps, [&](int i) { return P[i]; });
    if (left)
      op.store_colT(Ah, ps, [&](int i) { return R[i]; });
    else
      op.store_row(Ah, ps, [&](int i) { return R[i]; });
    __syncthreads();

    // matrix sign gate: quintic steps S2 = st(S S), S3 = S2 S,
    // S5 = S2 st(S3), S = st(a S + b S3 + c S5); then cubic polish steps
    // S = st(1.5 S - 0.5 S st(S S))
    for (int it = 0; it < n_aggr; ++it) {
      op.template mma_frag<W, W, NT>(P, S_row, op.rows, S_colT);
      op.store_row(S2_row, ps, [&](int i) { return P[i]; });
      __syncthreads();
      op.template mma_frag<W, W, NT>(R, S2_row, op.rows, S_colT);
      op.store_colT(S3_colT, ps, [&](int i) { return R[i]; });
      __syncthreads();
      op.template mma_frag<W, W, NT>(P, S2_row, op.rows, S3_colT);
#pragma unroll
      for (int i = 0; i < NS; ++i)
        P[i] = qa * own(S_row, i) + qb * R[i] + qc * P[i];
      op.store_row(S_row, ps, [&](int i) { return P[i]; });
      op.store_colT(S_colT, ps, [&](int i) { return P[i]; });
      __syncthreads();
    }
    for (int it = 0; it < n_polish; ++it) {
      op.template mma_frag<W, W, NT>(P, S_row, op.rows, S_colT);
      op.store_colT(S3_colT, ps, [&](int i) { return P[i]; });
      __syncthreads();
      op.template mma_frag<W, W, NT>(R, S_row, op.rows, S3_colT);
#pragma unroll
      for (int i = 0; i < NS; ++i) R[i] = 1.5f * own(S_row, i) - 0.5f * R[i];
      __syncthreads();  // every warp has read S_row
      op.store_row(S_row, ps, [&](int i) { return R[i]; });
      op.store_colT(S_colT, ps, [&](int i) { return R[i]; });
      __syncthreads();
    }

    if (!left) {
      // right: Q = sum_j coef_j T_j(Ah), T_j = 2 Ah st(T_{j-1}) - T_{j-2},
      // each product summed from -T_{j-2} / 2 and doubled; st(T) on the B
      // side in S_colT / S2_row by turns, Q in shared memory (the note at
      // the top): element i of the thread at Qs[qat(i)], where `live(i)`
      float* Qs = kF32 ? reinterpret_cast<float*>(S3_colT)
                       : reinterpret_cast<float*>(smraw + L.qs);
      auto qat = [&](int i) {
        return kF32 ? ps.row(i) * op.ld + ps.col(i) : i * NT + tid;
      };
      auto live = [&](int i) {
        return !kF32 || (ps.row(i) < op.rows && ps.col(i) < op.rows);
      };
      T* tb0 = S_colT;
      T* tb1 = S2_row;
      float tp[NS], tcur[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float d = tc::diag(ps, i, p), a = own(Ah, i);
        tp[i] = d;
        tcur[i] = a;
        if (live(i)) Qs[qat(i)] = coef[0] * d + coef[1] * a;
      }
      op.store_colT(tb0, ps, [&](int i) { return tcur[i]; });
      __syncthreads();
      T* tb = tb0;
      for (int j = 2; j <= wdeg; ++j) {
#pragma unroll
        for (int i = 0; i < NS; ++i) tp[i] *= -0.5f;
        op.template mma_acc<W, W, NT>(tp, Ah, op.rows, tb);
        const float cj = coef[j];
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const float tn = 2.f * tp[i];
          if (live(i)) Qs[qat(i)] += cj * tn;
          tp[i] = tcur[i];
          tcur[i] = tn;
        }
        if (j < wdeg) {
          tb = tb == tb0 ? tb1 : tb0;
          op.store_colT(tb, ps, [&](int i) { return tcur[i]; });
          __syncthreads();
        }
      }
      __syncthreads();  // every product has read its operands
      // F = st(W) st(Q), W = (S + I) / 2 in place of S; st(F) on the B
      // side in Ah's buffer
#pragma unroll
      for (int i = 0; i < NS; ++i)
        tcur[i] = 0.5f * (own(S_row, i) + tc::diag(ps, i, p));
      op.store_row(S_row, ps, [&](int i) { return tcur[i]; });
      op.store_colT(tb0, ps, [&](int i) { return Qs[qat(i)]; });
      __syncthreads();
      op.template mma_frag<W, W, NT>(P, S_row, op.rows, tb0);
      op.store_colT(Ah, ps, [&](int i) { return P[i]; });
      __syncthreads();
      // xn = hi + mid + lo exactly (three bf16 parts, rows padded to 16),
      // or xn in f32 (split in registers)
      const int kpad = tc::round_up(K, 16), pstride = kpad * op.ld;
      T* parts = S_row;
      tc::load_padded<W, NT>(xn + base, kpad, K, p,
                             [&](int r, int c, float v) {
        if constexpr (kF32) {
          op.put(parts, r, c, v);
        } else {
          const bf16 h = __float2bfloat16_rn(v);
          const float r1 = v - __bfloat162float(h);
          const bf16 m = __float2bfloat16_rn(r1);
          parts[r * op.ld + c] = h;
          parts[pstride + r * op.ld + c] = m;
          parts[2 * pstride + r * op.ld + c] =
              __float2bfloat16_rn(r1 - __bfloat162float(m));
        }
      });
      __syncthreads();
      // out = xn st(F) in rows of m16n8 tiles over the warps
      const int mt = kpad / 16, nt = (p + 7) / 8;
      const tc::Units un(mt, nt, NW);
      for (int u = warp; u < mt * un.ns; u += NW) {
        const int mi = u / un.ns, n_lo = (u - mi * un.ns) * un.nh;
        const int cnt = min(un.nh, nt - n_lo);
        if (cnt <= 0) continue;
        float c[8][4] = {};
        if constexpr (kF32)
          op.mma_rows(c, parts, kpad, 16 * mi, Ah, 8 * n_lo, cnt);
        else
          tc::mma_rows3(c, parts, pstride, 16 * mi, Ah, 8 * n_lo, op.ld, cnt,
                        op.kt);
        tc::apply_rows(o, K, p, 16 * mi, 8 * n_lo, cnt, c,
                       [&](int, int, float v) { return v; });
      }
    } else {
      // left: z_0 = xn W (f32 operands, CUDA cores), z_1 = st(z_0) Ah,
      // z_j = 2 st(z_{j-1}) Ah - z_{j-2} (summed from -z_{j-2} / 2 and
      // doubled), out = sum_j coef_j z_j; st(z) on the A side by turns
      float* XnT = reinterpret_cast<float*>(smraw + L.xnt);
      float* Wf = reinterpret_cast<float*>(smraw + L.wf);
      float* part3 = reinterpret_cast<float*>(smraw + L.part3);
      T* zb0 = S_row;  // over xn^T once z_0 is done
      T* zb1 = zb0 + 64 * op.ld;
      float w[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i)
        w[i] = 0.5f * (own(S_row, i) + tc::diag(ps, i, p));
      __syncthreads();  // S_row lies under xn^T and W
      tc::load_padded<W, NT>(xn + base, 64, K, p,
                             [&](int r, int c, float v) {
        if (c < p) XnT[c * LDX + r] = v;
      });
#pragma unroll
      for (int i = 0; i < NS; i += 2)
        if (ps.row(i) < p)
          *reinterpret_cast<float2*>(Wf + ps.row(i) * LDK + ps.col(i)) =
              make_float2(w[i], w[i + 1]);
      __syncthreads();
      float zp[NZ], zc[NZ], acc[NZ];
      tc::syrk<64, W, NT>(zp, XnT, LDX, Wf, LDK, p, part3, pz);
      op.store_row(zb0, pz, [&](int i) { return zp[i]; });
      __syncthreads();
      op.template mma_frag<64, W, NT>(zc, zb0, op.rows, Ah);
#pragma unroll
      for (int i = 0; i < NZ; ++i) acc[i] = coef[0] * zp[i] + coef[1] * zc[i];
      T* zb = zb0;
      for (int j = 2; j <= wdeg; ++j) {
        zb = zb == zb0 ? zb1 : zb0;
        op.store_row(zb, pz, [&](int i) { return zc[i]; });
        __syncthreads();
#pragma unroll
        for (int i = 0; i < NZ; ++i) zp[i] *= -0.5f;
        op.template mma_acc<64, W, NT>(zp, zb, op.rows, Ah);
        const float cj = coef[j];
#pragma unroll
        for (int i = 0; i < NZ; ++i) {
          const float zn = 2.f * zp[i];
          acc[i] = acc[i] + cj * zn;
          zp[i] = zc[i];
          zc[i] = zn;
        }
      }
#pragma unroll
      for (int i = 0; i < NZ; ++i) {
        const int r = pz.row(i), c = pz.col(i);
        if (r < K && c < p) o[r * p + c] = acc[i];
      }
    }
    __syncthreads();  // the next group overwrites shared memory
  }
}

// the tensor-core design's kernel at a width, bf16 operands or split TF32
// (the instantiations share one signature)
using TcKernel = decltype(&poly_tc_kernel<64, tc::OpBf16<64>>);

TcKernel tc_kernel(int width, bool f32) {
  if (f32)
    return width == 64 ? &poly_tc_kernel<64, tc::OpTf32>
                       : &poly_tc_kernel<128, tc::OpTf32>;
  return width == 64 ? &poly_tc_kernel<64, tc::OpBf16<64>>
                     : &poly_tc_kernel<128, tc::OpBf16<128>>;
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

// Dynamic shared memory of the tensor-core design for (K, p) groups (bf16
// operands when rnd, else split TF32) and the blocks it keeps on one SM
// (both 0: the design does not take them); returns a cudaError_t.
extern "C" int vnlb_poly_filter_tc_plan(int K, int p, int rnd, int* smem,
                                        int* per_sm) {
  const TcLayout L = tc_layout(K, p, !rnd);
  *smem = L.bytes;
  *per_sm = 0;
  if (L.width == 0) return 0;
  int grid = 0;
  return tc::occupancy_grid((const void*)tc_kernel(L.width, !rnd),
                            L.width == 64 ? tc::Width<64>::kThreads
                                          : tc::Width<128>::kThreads,
                            L.bytes, 1, &grid, per_sm);
}

// The tensor-core design on (G, K, p) groups, bf16 operands when rnd, else
// split TF32 (arguments as vnlb_poly_filter's); cudaErrorInvalidValue for
// a shape it does not take.
extern "C" int vnlb_poly_filter_tc(const float* xc, const float* xn,
                                   float* out, int G, int K, int p,
                                   int n_aggr, int n_polish, int wdeg,
                                   int nodes, const float* xs,
                                   const float* dct, float tau, float sb2,
                                   float s2, float qa, float qb, float qc,
                                   int rnd, void* stream) {
  if (G <= 0) return 0;
  const TcLayout L = tc_layout(K, p, !rnd);
  if (L.width == 0 || nodes > kMaxNodes || wdeg + 1 > kMaxCoef || wdeg < 1)
    return (int)cudaErrorInvalidValue;
  const int threads = L.width == 64 ? tc::Width<64>::kThreads
                                    : tc::Width<128>::kThreads;
  const TcKernel kernel = tc_kernel(L.width, !rnd);
  int grid = 0;
  const int err = tc::occupancy_grid((const void*)kernel, threads, L.bytes,
                                     G, &grid, nullptr);
  if (err != 0) return err;
  kernel<<<grid, threads, L.bytes, (cudaStream_t)stream>>>(
      xc, xn, out, G, K, p, n_aggr, n_polish, wdeg, nodes, xs, dct, tau, sb2,
      s2, qa, qb, qc, L);
  return (int)cudaGetLastError();
}
