// K1: per-site patch distances of the dense zero-flow search, of the
// per-site gather search (flow-tracked, sliding windows) and of the halo
// tile search.
//
// Replaces the Pallas kernel vnlb_tpu/ops/pallas_smat.py:280 (`_kernel`,
// launched at pallas_smat.py:378 by `_smat_chunked_call`, reached through
// `smat_distances_dt` :566, `smat_distances_coarse` :578 and
// `smat_distances_dt_tile` :526).  The TPU kernel computes box sums of
// squared differences for whole lattice rows with selection matmuls on the
// MXU, in a phase-major layout; here every site gets its own row of w_s*w_s
// distances directly.
//
// What it computes, for site s, temporal offset dt = dt_lo + blockIdx.y and
// candidate offset (a, b) in the w_s x w_s window:
//   out[dt][s][a*w_s+b] = sum_{f<pt, c<C, i<ps, j<ps}
//       (V[t+f, c, y+i, x+j] - V[t+dt+f, c, y0+a+i, x0+b+j])^2
// with zero read outside the frame (and for frames outside [0, T)).  The
// window starts at (y0, x0) = (y-half, x-half), or at (sy, sx)[dt][s] when
// the caller passes window starts (the gather search; the TPU computes that
// path with XLA convolutions, vnlb_tpu/ops/search.py:207-259).  The tile
// entry (`vnlb_patch_dist_tile`) runs on a halo strip tile whose row 0 is
// global row `base_row`, and writes +inf for every candidate whose GLOBAL
// corner falls outside [0, hp_g-1] x [0, wp_g-1] (the out-of-bounds mask of
// exec_search_dense_tile, vnlb_tpu/ops/search_dense.py:448-453).  Output is
// f32; the caller rounds.
//
// What bounds it on the H100: the FP32 pipe.  Per (site, dt) it reads one
// (w_s+ps-1)^2 region and one patch per plane (~12 KB at stage-1 shapes,
// from L2: neighbouring sites read the same pixels) and does
// w_s^2 * pt*C * ps^2 terms (~66 K), each an FADD (d = q - g) and an FFMA
// (acc += d*d), so issue slots, not bytes, set its time.
//
// The design:
// * Register-tiled candidates.  A thread owns a kRA x kMB micro-tile of
//   neighbouring candidates (rows a0.., columns b0..).  Per plane it holds
//   the query patch in registers (ps^2 values, a broadcast load), and for
//   each of the kRA+ps-1 region rows under its tile loads one row segment
//   of kMB+ps-1 values into registers and applies it to every candidate row
//   that needs it: 148 shared loads for 735 terms at ps=7 (0.5 terms per
//   load in the one-thread-per-candidate design this replaces).
// * Several (site, dt) pairs per block.  A group of nA*nB threads (one per
//   micro-tile, nA = ceil(w_s/kRA), nB = ceil(w_s/kMB)), padded to half a
//   warp or whole warps, serves one pair; the block holds 256 / lanes
//   groups (16 of 16 lanes at w_s=15, 15 of them owning a tile; 4 of 64
//   at w_s=27, 54 owning one).  The two groups of a warp stage their
//   planes 16 mod 32 floats apart, so their region loads hit disjoint
//   banks; within a group the 15 tiles of w_s=15 do too.  The padding
//   lanes copy but own no candidates.  Ragged micro-tiles read a padded
//   region (Rr = nA*kRA+ps-1 rows, Rc = nB*kMB+ps-1 columns) and are not
//   written.  blockIdx.y is the dt plane, blockIdx.x a run of P*M sites:
//   each group walks M sites (M from the plan: more when the grid has
//   blocks to spare), so a stage-0 pair (pt*C = 1, one plane) also has a
//   successor to prefetch.
// * Overlapped loads.  The pipeline runs over (pair, plane) stages; the
//   next stage's region plane and query patch are copied with cp.async
//   into the other half of a double buffer while this stage computes.
//   Each lane copies one or two columns of every region row, testing the
//   columns once per stage and the row once per row.
//   A group synchronizes only its own lanes, once per stage (a warp sync
//   at w_s=15, where two groups share a warp), so no warp waits for the
//   rest of the block.
//   Pixels outside the video are copied with src-size 0 (zero fill) from
//   the nearest pixel inside it, so no address outside the video is
//   formed.
//   Shared memory holds one plane per buffer, so it does not grow with
//   pt*C (63,488 bytes per block at w_s=15, ps=7).
// * The summation order of every candidate is that of the design it
//   replaces: planes (f, c) outer, then patch rows i, then columns j, one
//   fmaf(d, d, acc) per term with d = q - g.  So the output is bitwise
//   equal to it.  The tile entry skips the arithmetic of a micro-tile
//   whose candidates are all outside the frame; a micro-tile that
//   straddles the edge is masked per candidate.
// `vnlb_patch_dist_plan` returns the launch plan (mirrored by
// ops/patch_dist.plan) and the occupancy the card grants it.

#include <cuda_runtime.h>

namespace {

constexpr int kRA = 3;            // candidate rows of a micro-tile
constexpr int kMB = 5;            // candidate columns of a micro-tile
constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 2;     // blocks per SM the design is built for
constexpr int kMaxSitesPerGroup = 4;
// blocks for four waves of kMinBlocks blocks on the H100's 132 SMs: a grid
// beyond it lets each group walk more than one site
constexpr long long kWaveBlocks = 132LL * kMinBlocks * 4;

struct Plan {
  int nA, nB, tpp, lanes, P, M, Rr, Rc, stride, threads, smem, grid_x;
};

Plan make_plan(int ps, int w_s, int S, int n_dt) {
  Plan pl{};
  pl.nA = (w_s + kRA - 1) / kRA;
  pl.nB = (w_s + kMB - 1) / kMB;
  pl.tpp = pl.nA * pl.nB;
  // a group is half a warp or whole warps, so no warp mixes three groups
  pl.lanes = pl.tpp <= 16 ? 16 : (pl.tpp + 31) / 32 * 32;
  pl.P = kMaxThreads / pl.lanes;
  pl.Rr = pl.nA * kRA + ps - 1;
  pl.Rc = pl.nB * kMB + ps - 1;
  // a lane copies at most two columns of a region row
  if (pl.Rc > 2 * pl.lanes) pl.P = 0;
  if (pl.P <= 0) return pl;
  long long m = (long long)S * n_dt / (pl.P * kWaveBlocks);
  pl.M = (int)(m < 1 ? 1 : (m > kMaxSitesPerGroup ? kMaxSitesPerGroup : m));
  // one stage of a group: the query patch (padded to whole float4s), then
  // the region plane; 16 mod 32 floats apart, so the two groups of a warp
  // read disjoint banks
  pl.stride = (pl.Rr * pl.Rc + (ps * ps + 3) / 4 * 4 + 15) / 32 * 32 + 16;
  pl.threads = pl.P * pl.lanes;
  pl.smem = 2 * pl.P * pl.stride * (int)sizeof(float);
  const int per_block = pl.P * pl.M;
  pl.grid_x = (S + per_block - 1) / per_block;
  return pl;
}

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ bool inside(int v, int n) {
  return (unsigned)v < (unsigned)n;
}

// v clamped into [0, n)
__device__ __forceinline__ int clampi(int v, int n) {
  return min(max(v, 0), n - 1);
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The threads of one group (a pair's lanes) wait for each other: a half-
// or whole-warp group with __syncwarp, a group of several warps with a
// named barrier of its own (ids 1..P; P <= 8 then).  Both order the
// group's shared-memory writes, cp.async's included once waited for, with
// its reads.  No block-wide barrier: each group runs at its own pace.
__device__ __forceinline__ void group_sync(int p, int lanes) {
  if (lanes <= 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(p + 1), "r"(lanes));
}

template <int PS, bool kTile>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
patch_dist_kernel(const float* __restrict__ vid, int T, int C, int H, int W,
                  const int* __restrict__ qt, const int* __restrict__ qy,
                  const int* __restrict__ qx, const int* __restrict__ sy,
                  const int* __restrict__ sx, int S, int dt_lo, int pt,
                  int w_s, int base_row, int hp_g, int wp_g, Plan pl,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kPP = PS * PS;
  constexpr int kPP4 = (kPP + 3) / 4;   // float4s of the query patch
  constexpr int kRows = kRA + PS - 1;   // region rows under a micro-tile
  constexpr int kSeg = kMB + PS - 1;    // region columns under it
  const int tid = threadIdx.x;
  const int p = tid / pl.lanes, l = tid - p * pl.lanes;
  const bool owner = l < pl.tpp;   // the other lanes only copy
  const int ta = l / pl.nB, tb = l - ta * pl.nB;
  const int a0 = ta * kRA, b0 = tb * kMB;
  const int cp = pt * C, half = (w_s - 1) / 2, ws2 = w_s * w_s;
  const int dti = blockIdx.y, dt = dt_lo + dti;
  const size_t hw = (size_t)H * W;
  // this lane's part of a region copy: column c0 (and c0 + lanes when the
  // region is wider than the group) of rows r0, r0 + r_step, ...; a group
  // of more lanes than columns splits the rows
  const int r_step = max(1, pl.lanes / pl.Rc);
  const int c0 = l % pl.Rc;
  const int r0 = l / pl.Rc < r_step ? l / pl.Rc : pl.Rr;   // else no rows
  const bool two_cols = c0 + pl.lanes < pl.Rc;
  const int site0 = blockIdx.x * pl.P * pl.M + p;
  const int n_stage = pl.M * cp;

  // issue the copies of stage n (site m = n / cp, plane k = n % cp)
  auto load = [&](int n, int buf) {
    const int m = n / cp, k = n - m * cp;
    const int s = site0 + m * pl.P;
    if (s >= S) return;
    const int f = k / C, c = k - f * C;
    const int t = qt[s], y = qy[s], x = qx[s];
    const size_t ds = (size_t)dti * S + s;
    const int y0 = sy ? sy[ds] : y - half, x0 = sx ? sx[ds] : x - half;
    float* qry = smem + (buf * pl.P + p) * pl.stride;
    float* reg = qry + 4 * kPP4;
    const int tq = t + f, tg = t + dt + f;
    const bool qok = tq >= 0 && tq < T, gok = tg >= 0 && tg < T;
    // every source address is clamped into the video; a pixel outside it
    // is copied with src-size 0 (zeros)
    const float* qplane = vid + ((size_t)clampi(tq, T) * C + c) * hw;
    const float* gplane = vid + ((size_t)clampi(tg, T) * C + c) * hw;
    for (int e = l; e < kPP; e += pl.lanes) {
      const int i = e / PS, j = e - i * PS;
      const int yy = y + i, xx = x + j;
      copy4(qry + e, qplane + (size_t)clampi(yy, H) * W + clampi(xx, W),
            qok && inside(yy, H) && inside(xx, W));
    }
    // the lane's columns c0 and c0 + lanes (when inside the region) of
    // rows r0, r0 + r_step, ...: the column tests once per stage
    const int x1 = x0 + c0, x2 = x1 + pl.lanes;
    const bool ok1 = gok && inside(x1, W);
    const bool ok2 = gok && two_cols && inside(x2, W);
    const int x1c = clampi(x1, W), x2c = clampi(x2, W);
    float* dst = reg + r0 * pl.Rc + c0;
    for (int r = r0; r < pl.Rr; r += r_step, dst += r_step * pl.Rc) {
      const int yy = y0 + r;
      const bool yok = inside(yy, H);
      const float* row = gplane + (size_t)clampi(yy, H) * W;
      copy4(dst, row + x1c, yok && ok1);
      if (two_cols) copy4(dst + pl.lanes, row + x2c, yok && ok2);
    }
  };

  float acc[kRA][kMB];
  bool live = true;   // the tile entry: some candidate of the tile in frame
  load(0, 0);
  commit();
  for (int n = 0; n < n_stage; ++n) {
    // stage n has landed for the whole group, and the group is done with
    // stage n - 1, whose buffer the copies of stage n + 1 now refill
    wait_pending<0>();
    group_sync(p, pl.lanes);
    if (n + 1 < n_stage) {
      load(n + 1, (n + 1) & 1);
      commit();
    }
    const int m = n / cp, k = n - m * cp;
    const int s = site0 + m * pl.P;
    if (s < S && owner) {
      const size_t ds = (size_t)dti * S + s;
      const int y0 = sy ? sy[ds] : qy[s] - half;
      const int x0 = sx ? sx[ds] : qx[s] - half;
      if (k == 0) {
#pragma unroll
        for (int da = 0; da < kRA; ++da)
#pragma unroll
          for (int db = 0; db < kMB; ++db) acc[da][db] = 0.f;
        if (kTile) {
          // rows a with 0 <= y0 + a + base_row <= hp_g - 1, columns b with
          // 0 <= x0 + b <= wp_g - 1, within this micro-tile and the window
          const int a_lo = max(a0, -base_row - y0);
          const int a_hi = min(min(a0 + kRA, w_s) - 1, hp_g - 1 - base_row - y0);
          const int b_lo = max(b0, -x0);
          const int b_hi = min(min(b0 + kMB, w_s) - 1, wp_g - 1 - x0);
          live = a_lo <= a_hi && b_lo <= b_hi;
        }
      }
      if (live) {
        const float* qs = smem + ((n & 1) * pl.P + p) * pl.stride;
        const float* reg = qs + 4 * kPP4;
        float q[4 * kPP4];   // a broadcast 16-byte load per 4 values
#pragma unroll
        for (int e = 0; e < kPP4; ++e) {
          const float4 v = reinterpret_cast<const float4*>(qs)[e];
          q[4 * e] = v.x;
          q[4 * e + 1] = v.y;
          q[4 * e + 2] = v.z;
          q[4 * e + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float* row = reg + (a0 + r) * pl.Rc + b0;
          float g[kSeg];
#pragma unroll
          for (int u = 0; u < kSeg; ++u) g[u] = row[u];
#pragma unroll
          for (int da = 0; da < kRA; ++da) {
            const int i = r - da;   // the patch row candidate row da needs
            if (i < 0 || i >= PS) continue;
#pragma unroll
            for (int db = 0; db < kMB; ++db) {
#pragma unroll
              for (int j = 0; j < PS; ++j) {
                const float d = q[i * PS + j] - g[db + j];
                acc[da][db] = fmaf(d, d, acc[da][db]);
              }
            }
          }
        }
      }
      if (k == cp - 1) {
        float* o = out + ds * ws2;
#pragma unroll
        for (int da = 0; da < kRA; ++da) {
          const int a = a0 + da;
          if (a >= w_s) continue;
#pragma unroll
          for (int db = 0; db < kMB; ++db) {
            const int b = b0 + db;
            if (b >= w_s) continue;
            float v = acc[da][db];
            if (kTile) {
              const int cy = y0 + a + base_row, cx = x0 + b;
              if (cy < 0 || cy > hp_g - 1 || cx < 0 || cx > wp_g - 1)
                v = __int_as_float(0x7f800000);  // +inf
            }
            o[a * w_s + b] = v;
          }
        }
      }
    }
  }
}

template <int PS, bool kTile>
int launch_ps(const float* vid, int T, int C, int H, int W, const int* qt,
              const int* qy, const int* qx, const int* sy, const int* sx,
              int S, int dt_lo, int n_dt, int pt, int w_s, int base_row,
              int hp_g, int wp_g, float* out, void* stream) {
  const Plan pl = make_plan(PS, w_s, S, n_dt);
  if (pl.P <= 0) return (int)cudaErrorInvalidValue;
  auto kernel = patch_dist_kernel<PS, kTile>;
  if (pl.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(pl.grid_x, n_dt);
  kernel<<<grid, pl.threads, pl.smem, (cudaStream_t)stream>>>(
      vid, T, C, H, W, qt, qy, qx, sy, sx, S, dt_lo, pt, w_s, base_row, hp_g,
      wp_g, pl, out);
  return (int)cudaGetLastError();
}

template <bool kTile>
int launch(const float* vid, int T, int C, int H, int W, const int* qt,
           const int* qy, const int* qx, const int* sy, const int* sx, int S,
           int dt_lo, int n_dt, int pt, int ps, int w_s, int base_row,
           int hp_g, int wp_g, float* out, void* stream) {
  if (S <= 0 || n_dt <= 0) return 0;
  switch (ps) {
    case 3:
      return launch_ps<3, kTile>(vid, T, C, H, W, qt, qy, qx, sy, sx, S,
                                 dt_lo, n_dt, pt, w_s, base_row, hp_g, wp_g,
                                 out, stream);
    case 5:
      return launch_ps<5, kTile>(vid, T, C, H, W, qt, qy, qx, sy, sx, S,
                                 dt_lo, n_dt, pt, w_s, base_row, hp_g, wp_g,
                                 out, stream);
    case 7:
      return launch_ps<7, kTile>(vid, T, C, H, W, qt, qy, qx, sy, sx, S,
                                 dt_lo, n_dt, pt, w_s, base_row, hp_g, wp_g,
                                 out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// vid: (T, C, H, W) f32; qt/qy/qx: (S,) int32 query corners; sy/sx: null,
// or (n_dt, S) int32 window starts; out: (n_dt, S, w_s*w_s) f32 for
// dt = dt_lo .. dt_lo+n_dt-1.  ps is 3, 5 or 7.
extern "C" int vnlb_patch_dist(const float* vid, int T, int C, int H, int W,
                               const int* qt, const int* qy, const int* qx,
                               const int* sy, const int* sx, int S, int dt_lo,
                               int n_dt, int pt, int ps, int w_s, float* out,
                               void* stream) {
  return launch<false>(vid, T, C, H, W, qt, qy, qx, sy, sx, S, dt_lo, n_dt,
                       pt, ps, w_s, 0, 0, 0, out, stream);
}

// The tile entry: vid is a (T, C, Ht, W) halo tile whose row 0 is global
// row base_row; qt/qy/qx are tile-coordinate query corners; candidates with
// a global corner outside [0, hp_g-1] x [0, wp_g-1] are +inf.
extern "C" int vnlb_patch_dist_tile(const float* vid, int T, int C, int H,
                                    int W, const int* qt, const int* qy,
                                    const int* qx, int S, int dt_lo, int n_dt,
                                    int pt, int ps, int w_s, int base_row,
                                    int hp_g, int wp_g, float* out,
                                    void* stream) {
  return launch<true>(vid, T, C, H, W, qt, qy, qx, nullptr, nullptr, S,
                      dt_lo, n_dt, pt, ps, w_s, base_row, hp_g, wp_g, out,
                      stream);
}

// The launch plan of (ps, w_s, S, n_dt) into out[0..12], in the order of
// ops/patch_dist.PLAN_FIELDS (threads, lanes per group, pairs per block,
// sites per group, micro-tile rows, micro-tile columns, tiles down, tiles
// across, region rows, region columns, shared bytes, blocks per SM of the
// design, grid x), then out[13] = the blocks per SM that the card grants
// the dense entry's kernel at that plan.  Returns a cudaError_t (invalid value for
// an unsupported ps or w_s).
extern "C" int vnlb_patch_dist_plan(int ps, int w_s, int S, int n_dt,
                                    int* out) {
  const Plan pl = make_plan(ps, w_s, S, n_dt);
  if (pl.P <= 0 || (ps != 3 && ps != 5 && ps != 7))
    return (int)cudaErrorInvalidValue;
  const int v[13] = {pl.threads, pl.lanes, pl.P,  pl.M,    kRA,
                     kMB,        pl.nA,    pl.nB, pl.Rr,   pl.Rc,
                     pl.smem,    kMinBlocks, pl.grid_x};
  for (int i = 0; i < 13; ++i) out[i] = v[i];
  const void* fn = ps == 3   ? (const void*)patch_dist_kernel<3, false>
                   : ps == 5 ? (const void*)patch_dist_kernel<5, false>
                             : (const void*)patch_dist_kernel<7, false>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, pl.threads,
                                                      pl.smem);
  out[13] = blocks;
  return (int)err;
}
