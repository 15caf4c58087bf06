// K6: the aggregation's segmented row scatter into the column-space
// accumulator.
//
// Replaces no Pallas kernel: the JAX package leaves this scatter to XLA
// (`acc.at[rows].add(upd)`, vnlb_tpu/ops/agg.py:85-106).  It was added
// because the port's torch scatter (two stable sorts, a cummax, a count
// read back to the host and one indexed read-add-write round per
// occurrence rank, ops/agg.scatter_add_rows) ran at about 15x the byte
// bound below on the 480p cells (PERF.md §5), and synced the host once a
// chunk.
//
// What it computes.  The wrapper sorts the chunk's flat accumulator rows
// stably (`srt`, with the permutation `perm`); update j = perm[i] is patch
// k = j % ka of site b = j / ka.  For every distinct row r, in the order of
// its updates in the chunk (the stable sort keeps it):
//   acc[r][l]   = ((acc[r][l] + u0[l]) + u1[l]) + ...
//   u[l]        = rnd(P[b][k][l] * w[b][k])   for l < L - 1
//   u[L - 1]    = rnd(w[b][k])                (the weight lane)
// with P the filter's (B, K, pt, C, ps, ps) output read in place, at its
// strides (the first ka of its K patches; the filter leaves it c-major,
// (B, C, K, pt, ps, ps) in memory, so a lane's offset in the patch comes
// from its (j, c, dy, dx) and the patch's strides) and rnd the
// round to bf16 and back when `bf16` is set, else the identity.  That is
// the f32 sequence the ranked rounds perform, so the result is bitwise the
// plain version's: every multiply and add is a separate round-to-nearest
// intrinsic (no FMA contraction), and weight-0 updates are multiplied too,
// so an inf or NaN in a weight-0 patch gives NaN as it does there.
//
// What bounds it on the H100: bytes, at about 0.3 operations a byte.  A
// chunk reads each update row once (4096 sites x 32 patches x 147 or 294
// floats: 77 or 154 MB) and reads and writes each distinct accumulator row
// once (0.88 of the update rows on preset iphone, 0.69 on default): about
// 2.22 + 2 x 0.88 x 2.22 = 6.1 GB a 480p frame, 1.8 ms at 3.35 TB/s.  The
// design moves nothing else and never asks the host: one warp per sorted
// position, so the launch needs no segment count; a warp whose position
// does not start a segment exits at once; a segment head keeps its
// accumulator row in registers (kTile floats a lane, column passes of
// 32 * kTile lanes for wider rows), walks its segment reading each update
// row as 4-byte streaming loads (ps * ps consecutive lanes are contiguous
// in the c-major output, so a warp's loads fall in two or three runs), and
// stores the row once.  Each lane's offset in a patch depends on the
// layout alone: a block computes the table once into shared memory
// (lanes - 1 ints), so the walk does no division and the row stays in 32
// registers.  No atomics and no workspace: distinct rows belong to
// distinct warps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;   // warps a block
constexpr int kTile = 10;    // accumulator floats a lane: 320 lanes a pass
constexpr int kMaxLanes = 12288;   // patch lanes the offset table holds

template <bool kBf16>
__device__ __forceinline__ float rnd(float v) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <bool kBf16>
__global__ void __launch_bounds__(kWarps * 32)
scatter_rows_kernel(float* __restrict__ acc, int lanes,
                    const float* __restrict__ patches, long long s_b,
                    long long s_k, int4 dims, int4 strides,
                    const float* __restrict__ w, int ka,
                    const int* __restrict__ srt,
                    const long long* __restrict__ perm, int n) {
  extern __shared__ int off[];    // (lanes - 1,) patch lane -> offset
  const int d = lanes - 1;                          // the weight lane
  // l = ((l0 * dims.y + l1) * dims.z + l2) * dims.w + l3
  for (int l = threadIdx.x; l < d; l += kWarps * 32) {
    const int l3 = l % dims.w, r = l / dims.w;
    const int l2 = r % dims.z, q = r / dims.z;
    off[l] = (q / dims.y) * strides.x + (q % dims.y) * strides.y
             + l2 * strides.z + l3 * strides.w;
  }
  __syncthreads();
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const int row = srt[i];
  if (i > 0 && srt[i - 1] == row) return;          // not a segment head
  float* dst = acc + (long long)row * lanes;
  for (int c0 = 0; c0 < lanes; c0 += 32 * kTile) {
    float a[kTile];
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const int l = c0 + lane + 32 * t;
      a[t] = l < lanes ? dst[l] : 0.f;
    }
    for (int j = i; j < n && srt[j] == row; ++j) {
      const int p = (int)perm[j];                  // < n < 2^31
      const int b = p / ka;
      const float wt = w[p];
      const float* src = patches + b * s_b + (long long)(p - b * ka) * s_k;
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const int l = c0 + lane + 32 * t;
        if (l < d)
          a[t] = __fadd_rn(a[t],
                           rnd<kBf16>(__fmul_rn(__ldcs(src + off[l]), wt)));
        else if (l == d)
          a[t] = __fadd_rn(a[t], rnd<kBf16>(wt));
      }
    }
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const int l = c0 + lane + 32 * t;
      if (l < lanes) dst[l] = a[t];
    }
  }
}

}  // namespace

// acc (N, lanes) f32 contiguous; patches: patch (b, k) at b * s_b + k * s_k
// floats, its lanes - 1 values of shape d0 x d1 x d2 x d3 at strides t0-t3
// (lane l's offset < 2^31; lanes - 1 <= kMaxLanes, the offset table's 48
// KB); w (B, ka) f32 contiguous; srt (n,) int32 sorted rows, perm (n,)
// int64, n = B * ka.
extern "C" int vnlb_scatter_rows(float* acc, int lanes, const float* patches,
                                 long long s_b, long long s_k, int d0, int d1,
                                 int d2, int d3, int t0, int t1, int t2,
                                 int t3, const float* w, int ka,
                                 const int* srt, const long long* perm, int n,
                                 int bf16, void* stream) {
  if (n <= 0) return 0;
  if (lanes - 1 > kMaxLanes) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((n + kWarps - 1) / kWarps), block(kWarps * 32);
  const int4 dims = make_int4(d0, d1, d2, d3);
  const int4 strides = make_int4(t0, t1, t2, t3);
  const size_t smem = sizeof(int) * (lanes - 1);
  if (bf16)
    scatter_rows_kernel<true><<<grid, block, smem, s>>>(
        acc, lanes, patches, s_b, s_k, dims, strides, w, ka, srt, perm, n);
  else
    scatter_rows_kernel<false><<<grid, block, smem, s>>>(
        acc, lanes, patches, s_b, s_k, dims, strides, w, ka, srt, perm, n);
  return (int)cudaGetLastError();
}
