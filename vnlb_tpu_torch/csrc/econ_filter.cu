// K2: the economized polynomial spectral filter, one patch group per block.
//
// Replaces the Pallas kernel vnlb_tpu/ops/pallas_filter.py:106
// (`_filter_kernel`, launched at pallas_filter.py:260 by
// `poly_econ_gram_packed_pallas` and at :320 by `poly_econ_packed_pallas`),
// which computes the same function as the production XLA routes
// vnlb_tpu/ops/polyspec.py `_poly_econ_packed` (K >= p, matrix route) and
// `_poly_econ_gram_packed` (K < p, Gram route).  The TPU packs two groups
// per 128-lane tile; that is a layout device of the MXU and is dropped: a
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
// keeps the group's two patch blocks and seven q x q f32 matrices resident
// in shared memory (~148 KB at stage 1, ~106 KB at stage 0, so the
// dynamic shared-memory limit is raised), reads each input once and writes
// the output once; the products run on CUDA cores with a 2x2 tile of
// outputs per thread, rounding operands to bf16 in registers
// (__float2bfloat16_rn) and accumulating with fmaf.  Tensor cores (wgmma)
// are a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxNodes = 128;
constexpr int kMaxCoef = 64;

__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// C[i][j] = scale * sum_k opA(i,k) opB(k,j)  (+ f0 * Xadd[i][j] when given)
// opA(i,k) = TA ? A[k][i] : A[i][k], optionally alpha * a + beta [i == k];
// opB(k,j) = TB ? B[j][k] : B[k][j].  RND rounds both operands to bf16.
// Each thread owns a 2x2 tile {i, i + hn} x {j, j + hn2} of C (hn, hn2 =
// half the sizes, rounded up): per k it reads two A and two B values for
// four FMAs, and neighbouring threads read neighbouring B columns.
template <bool TA, bool TB, bool RND, bool XFORM>
__device__ __forceinline__ void block_mm(float* C, int ldc, const float* A,
                                         int lda, const float* B, int ldb,
                                         int n, int l, int n2, float alpha,
                                         float beta, float scale,
                                         const float* Xadd, float f0) {
  const int hn = (n + 1) / 2, hn2 = (n2 + 1) / 2;
  for (int e = threadIdx.x; e < hn * hn2; e += blockDim.x) {
    const int i0 = e / hn2, j0 = e - i0 * hn2;
    const bool ok_i = i0 + hn < n, ok_j = j0 + hn2 < n2;
    const int i1 = ok_i ? i0 + hn : i0, j1 = ok_j ? j0 + hn2 : j0;
    float c00 = 0.f, c01 = 0.f, c10 = 0.f, c11 = 0.f;
    for (int k = 0; k < l; ++k) {
      float a0 = TA ? A[k * lda + i0] : A[i0 * lda + k];
      float a1 = TA ? A[k * lda + i1] : A[i1 * lda + k];
      if (XFORM) {
        a0 = alpha * a0 + (i0 == k ? beta : 0.f);
        a1 = alpha * a1 + (i1 == k ? beta : 0.f);
      }
      float b0 = TB ? B[j0 * ldb + k] : B[k * ldb + j0];
      float b1 = TB ? B[j1 * ldb + k] : B[k * ldb + j1];
      if (RND) {
        a0 = rbf(a0);
        a1 = rbf(a1);
        b0 = rbf(b0);
        b1 = rbf(b1);
      }
      c00 = fmaf(a0, b0, c00);
      c01 = fmaf(a0, b1, c01);
      c10 = fmaf(a1, b0, c10);
      c11 = fmaf(a1, b1, c11);
    }
    const float cs[2][2] = {{c00, c01}, {c10, c11}};
    const int is[2] = {i0, i1}, js[2] = {j0, j1};
    for (int u = 0; u < 2; ++u) {
      if (u == 1 && !ok_i) break;
      for (int v = 0; v < 2; ++v) {
        if (v == 1 && !ok_j) break;
        const int i = is[u], j = js[v];
        float val = cs[u][v] * scale;
        if (Xadd != nullptr) val = f0 * Xadd[i * ldc + j] + val;
        C[i * ldc + j] = val;
      }
    }
  }
}

// square q x q product with bf16 or f32 operands
template <bool XFORM>
__device__ __forceinline__ void sq_mm(float* C, const float* A,
                                      const float* B, int q, bool rnd,
                                      float alpha = 1.f, float beta = 0.f) {
  if (rnd)
    block_mm<false, false, true, XFORM>(C, q, A, q, B, q, q, q, q, alpha,
                                        beta, 1.f, nullptr, 0.f);
  else
    block_mm<false, false, false, XFORM>(C, q, A, q, B, q, q, q, q, alpha,
                                         beta, 1.f, nullptr, 0.f);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
econ_filter_kernel(const float* __restrict__ xc, const float* __restrict__ xn,
                   float* __restrict__ out, int K, int p, int m, int s,
                   int nodes, const float* __restrict__ xs,
                   const float* __restrict__ proj,
                   const float* __restrict__ v0, float tau, float lub_floor,
                   float sb2, float s2, float cwg, int rnd) {
  extern __shared__ float sm[];
  __shared__ float fv[kMaxNodes];
  __shared__ float gam[kMaxCoef];
  __shared__ float scal[4];  // lub, f0, trace, max row sum

  const bool gram = K < p;
  const int q = gram ? K : p;
  const int kp = K * p, qq = q * q, ms = m * s;
  const int tid = threadIdx.x;
  float* X1 = sm;         // xc (K, p)
  float* X2 = X1 + kp;    // xn (K, p)
  float* Ma = X2 + kp;    // A
  float* Mb = Ma + qq;    // A^2
  float* Mc = Mb + qq;    // B = T_s(A)
  float* Md = Mc + qq;    // T_3(A) when s == 4
  float* b_hi = Md + qq;  // Clenshaw state
  float* b_lo = b_hi + qq;
  float* P = b_lo + qq;   // product scratch

  const size_t base = (size_t)blockIdx.x * kp;
  for (int e = tid; e < kp; e += blockDim.x) {
    X1[e] = xc[base + e];
    X2[e] = xn[base + e];
  }
  __syncthreads();

  // covariance (matrix route) or Gram (Gram route), f32 operands
  const float invk = 1.f / (float)K;
  if (gram)
    block_mm<false, true, false, false>(Ma, q, X1, p, X1, p, q, p, q, 1.f,
                                        0.f, invk, nullptr, 0.f);
  else
    block_mm<true, false, false, false>(Ma, q, X1, p, X1, p, q, K, q, 1.f,
                                        0.f, invk, nullptr, 0.f);
  __syncthreads();

  // spectral bound: max row |sum| into P[0..q), trace by warp 0
  for (int i = tid; i < q; i += blockDim.x) {
    float r = 0.f;
    for (int j = 0; j < q; ++j) r += fabsf(Ma[i * q + j]);
    P[i] = r;
  }
  __syncthreads();
  if (tid < 32) {
    float tr = 0.f, rs = 0.f;
    for (int i = tid; i < q; i += 32) {
      tr += Ma[i * q + i];
      rs = fmaxf(rs, P[i]);
    }
    tr = warp_sum(tr);
    rs = warp_max(rs);
    if (tid == 0) {
      scal[0] = fmaxf(fminf(tr, rs), lub_floor) * 1.02f;
    }
  }
  __syncthreads();
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
      for (int n = 0; n < nodes; ++n) acc = fmaf(fv[n], proj[n * ms + j], acc);
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
  const bool r16 = rnd != 0;
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
    if (r16)
      block_mm<false, false, true, false>(o, p, X2, p, P, q, K, p, p, 1.f,
                                          0.f, 1.f, nullptr, 0.f);
    else
      block_mm<false, false, false, false>(o, p, X2, p, P, q, K, p, p, 1.f,
                                           0.f, 1.f, nullptr, 0.f);
    return;
  }
  // Gram route: mh = xn xc^T (f32), t = mh F, out = f0 xn + t xc * 2/(K lub)
  block_mm<false, true, false, false>(Ma, q, X2, p, X1, p, K, p, K, 1.f, 0.f,
                                      1.f, nullptr, 0.f);
  __syncthreads();
  sq_mm<false>(Mb, Ma, P, q, r16);
  __syncthreads();
  const float yscale = 2.f / ((float)K * lub);
  if (r16)
    block_mm<false, false, true, false>(o, p, Mb, q, X1, p, K, K, p, 1.f, 0.f,
                                        yscale, X2, scal[1]);
  else
    block_mm<false, false, false, false>(o, p, Mb, q, X1, p, K, K, p, 1.f,
                                         0.f, yscale, X2, scal[1]);
}

}  // namespace

// Dynamic shared memory of one block, in bytes.
extern "C" long long vnlb_econ_filter_smem(int K, int p) {
  const int q = K < p ? K : p;
  return (long long)(2LL * K * p + 7LL * q * q) * (long long)sizeof(float);
}

// xc, xn, out: (G, K, p) f32 contiguous.  xs: (nodes,) Chebyshev nodes;
// proj: (nodes, m*s) node values -> econ coefficients; v0: (nodes,) node
// values -> f(-1) for the Gram route, null for the matrix route.
extern "C" int vnlb_econ_filter(const float* xc, const float* xn, float* out,
                                int G, int K, int p, int m, int s, int nodes,
                                const float* xs, const float* proj,
                                const float* v0, float tau, float lub_floor,
                                float sb2, float s2, float cwg, int rnd,
                                void* stream) {
  if (G <= 0) return 0;
  if (nodes > kMaxNodes || m * s > kMaxCoef || s < 2 || s > 4)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)vnlb_econ_filter_smem(K, p);
  cudaError_t err = cudaFuncSetAttribute(
      econ_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  econ_filter_kernel<<<G, kThreads, smem, (cudaStream_t)stream>>>(
      xc, xn, out, K, p, m, s, nodes, xs, proj, v0, tau, lub_floor, sb2, s2,
      cwg, rnd);
  return (int)cudaGetLastError();
}
