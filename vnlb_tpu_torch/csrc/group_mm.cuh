// Per-group matrix products and buffer placement shared by the filter
// kernels (econ_filter.cu, K2, and poly_filter.cu, K5).  Included, never
// compiled on its own.
//
// A filter kernel runs one patch group per block: the group's two patch
// blocks and a few square matrices.  `plan_slots` places those buffers:
// in priority order, each goes to dynamic shared memory while it still
// fits; a scratch buffer that does not fit goes to the block's slice of a
// workspace in device memory, and an input block that does not fit is read
// where it lies.  The products take plain pointers, so the same code runs
// on shared memory, on the workspace (served by L1 and the 50 MB L2) and
// on the inputs.  When anything spills, the launcher runs a persistent
// grid of one block per resident slot that walks the groups, so the
// workspace is (blocks x spilled floats), not (groups x spilled floats).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vnlb {

__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// C[i][j] = scale * sum_k opA(i,k) opB(k,j)  (+ f0 * Xadd[i][j] when given)
// opA(i,k) = TA ? A[k][i] : A[i][k], optionally alpha * a + beta [i == k];
// opB(k,j) = TB ? B[j][k] : B[k][j].  RA / RB round the A / B operands to
// bf16 (products of bf16 values are exact in f32; the sum is f32 fmaf).
// Each thread owns a 2x2 tile {i, i + hn} x {j, j + hn2} of C (hn, hn2 =
// half the sizes, rounded up): per k it reads two A and two B values for
// four FMAs, and neighbouring threads read neighbouring B columns.
template <bool TA, bool TB, bool RA, bool RB, bool XFORM>
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
      if (RA) {
        a0 = rbf(a0);
        a1 = rbf(a1);
      }
      if (RB) {
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

// Plain row-major C (n x n2) = A (n x l) B (l x n2), both operands rounded
// to bf16 when `rnd`.
__device__ __forceinline__ void mm_r(float* C, int ldc, const float* A,
                                     int lda, const float* B, int ldb, int n,
                                     int l, int n2, bool rnd) {
  if (rnd)
    block_mm<false, false, true, true, false>(C, ldc, A, lda, B, ldb, n, l,
                                              n2, 1.f, 0.f, 1.f, nullptr,
                                              0.f);
  else
    block_mm<false, false, false, false, false>(C, ldc, A, lda, B, ldb, n, l,
                                                n2, 1.f, 0.f, 1.f, nullptr,
                                                0.f);
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

// lub = max(min(trace(M), max_i sum_j |M[i][j]|), floor) * 1.02 of a q x q
// matrix, with `tmp` (q floats) as scratch; the result lands in *dst.
// Ends with a barrier.
__device__ __forceinline__ void spectral_bound(const float* M, int q,
                                               float* tmp, float floor_,
                                               float* dst) {
  const int tid = threadIdx.x;
  for (int i = tid; i < q; i += blockDim.x) {
    float r = 0.f;
    for (int j = 0; j < q; ++j) r += fabsf(M[i * q + j]);
    tmp[i] = r;
  }
  __syncthreads();
  if (tid < 32) {
    float tr = 0.f, rs = 0.f;
    for (int i = tid; i < q; i += 32) {
      tr += M[i * q + i];
      rs = fmaxf(rs, tmp[i]);
    }
    tr = warp_sum(tr);
    rs = warp_max(rs);
    if (tid == 0) *dst = fmaxf(fminf(tr, rs), floor_) * 1.02f;
  }
  __syncthreads();
}

// Shared memory a block may use on Hopper (227 KB), less 1 KB kept for the
// kernels' static arrays, in floats.
constexpr long long kSmemFloats = (232448 - 1024) / 4;
constexpr int kMaxSlots = 10;

enum SlotWhere { kShared = 0, kWorkspace = 1, kInPlace = 2 };

struct SlotPlan {
  int where[kMaxSlots];      // SlotWhere
  long long off[kMaxSlots];  // float offset in shared memory or workspace
  long long smem_floats;     // dynamic shared memory of one block
  long long ws_floats;       // workspace of one block
};

// First fit in priority order; `input[i]` marks a buffer that holds a copy
// of an input block (read in place when it does not fit).
inline SlotPlan plan_slots(int n, const long long* floats, const bool* input,
                           long long budget = kSmemFloats) {
  SlotPlan pl{};
  for (int i = 0; i < n; ++i) {
    if (pl.smem_floats + floats[i] <= budget) {
      pl.where[i] = kShared;
      pl.off[i] = pl.smem_floats;
      pl.smem_floats += floats[i];
    } else if (input[i]) {
      pl.where[i] = kInPlace;
    } else {
      pl.where[i] = kWorkspace;
      pl.off[i] = pl.ws_floats;
      pl.ws_floats += floats[i];
    }
  }
  return pl;
}

// Whether a plan keeps every scratch buffer / both input blocks in shared
// memory.  The kernels are instantiated for these cases: a pointer the
// compiler sees derived from the shared array is read with shared-memory
// loads, a pointer chosen at run time with slower generic ones.
inline bool scratch_shared(const SlotPlan& pl) { return pl.ws_floats == 0; }
inline bool inputs_shared(const SlotPlan& pl, int a, int b) {
  return pl.where[a] == kShared && pl.where[b] == kShared;
}

// The buffer of slot i (null for an input read in place); kShared_: the
// plan is known to keep it in shared memory.
template <bool kShared_>
__device__ __forceinline__ float* slot(const SlotPlan& pl, int i, float* sm,
                                       float* ws) {
  if (kShared_) return sm + pl.off[i];
  return pl.where[i] == kShared ? sm + pl.off[i]
         : pl.where[i] == kWorkspace ? ws + pl.off[i]
                                     : nullptr;
}

// The group's two input blocks of `n` floats at `sa`, `sb` (slots ia, ib):
// each copied into its slot `da` / `db` in one loop (two loads in flight
// per thread), or read in place.  The caller syncs before use.
template <bool kShared_>
__device__ __forceinline__ void load_inputs(const SlotPlan& pl, int ia,
                                            int ib, float* da, float* db,
                                            const float* sa, const float* sb,
                                            int n, const float** a,
                                            const float** b) {
  const bool ca = kShared_ || pl.where[ia] != kInPlace;
  const bool cb = kShared_ || pl.where[ib] != kInPlace;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    if (ca) da[e] = sa[e];
    if (cb) db[e] = sb[e];
  }
  *a = ca ? da : sa;
  *b = cb ? db : sb;
}

// Blocks of the launch: one per group when nothing spills, else one per
// resident slot (at most G).  Sets the kernel's dynamic shared-memory
// limit.  Returns a cudaError_t.
inline int plan_grid(const void* kernel, int threads, const SlotPlan& pl,
                     int G, int* grid) {
  const size_t smem = (size_t)pl.smem_floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (pl.ws_floats == 0) {
    *grid = G;
    return 0;
  }
  int dev = 0, sms = 0, occ = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  const long long slots = (long long)sms * (occ > 0 ? occ : 1);
  *grid = (int)(slots < G ? slots : G);
  return 0;
}

}  // namespace vnlb
