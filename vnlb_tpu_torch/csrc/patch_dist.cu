// K1: per-site patch distances of the dense zero-flow search and of the
// per-site gather search (flow-tracked, sliding windows).
//
// Replaces the Pallas kernel vnlb_tpu/ops/pallas_smat.py:280 (`_kernel`,
// launched at pallas_smat.py:378 by `_smat_chunked_call`, reached through
// `smat_distances_dt` and `smat_distances_coarse`).  The TPU kernel computes
// box sums of squared differences for whole lattice rows with selection
// matmuls on the MXU, in a phase-major layout; here every site gets its own
// row of w_s*w_s distances directly.
//
// What it computes, for site s, temporal offset dt = dt_lo + blockIdx.y and
// candidate offset (a, b) in the w_s x w_s window:
//   out[dt][s][a*w_s+b] = sum_{f<pt, c<C, i<ps, j<ps}
//       (V[t+f, c, y+i, x+j] - V[t+dt+f, c, y0+a+i, x0+b+j])^2
// with zero read outside the frame (and for frames outside [0, T)); no
// memory outside the video is ever read.  The window starts at (y0, x0) =
// (y-half, x-half), or at (sy, sx)[dt][s] when the caller passes window
// starts (the gather search's entry; the TPU computes that path with XLA
// convolutions, vnlb_tpu/ops/search.py:207-259).  Output is f32; the caller
// rounds.
//
// The tile entry (`vnlb_patch_dist_tile`) replaces the same Pallas kernel as
// launched by `smat_distances_dt_tile` (vnlb_tpu/ops/pallas_smat.py:526) for
// a halo strip of the H-sharded pass: the queries are tile coordinates, the
// tile's row 0 is global row `base_row` (negative on strip 0), and every
// candidate whose GLOBAL corner falls outside [0, hp_g-1] x [0, wp_g-1] gets
// +inf and no arithmetic (the out-of-bounds mask of exec_search_dense_tile,
// vnlb_tpu/ops/search_dense.py:448-453).  The TPU builds a 0/1 row-selection
// matrix on the device for that; here the window is explicit per site, so
// only the bound test is added.  In-bounds candidates run the same
// instructions as the dense entry, so both give the same bits.
//
// What bounds it on the H100: arithmetic, not bytes.  Per site and dt it
// reads one (w_s+ps-1)^2 region and one patch per channel plane (~11 KB at
// stage-1 shapes) and does w_s^2 * pt*C*ps^2 (~66 K) multiply-adds, i.e.
// ~24 FMAs per byte fetched.  The simple design stages the region and the
// query patch in shared memory once per (site, dt) so that all global reads
// are reused w_s^2 times; each thread then owns one candidate and
// accumulates in a register, so the inner loop is shared-memory bound
// (one broadcast query read + one region read per FMA).  Register tiling
// over neighbouring candidates is left to a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSitesPerBlock = 8;

template <bool kTile>
__global__ void __launch_bounds__(kThreads)
patch_dist_kernel(const float* __restrict__ vid, int T, int C, int H, int W,
                  const int* __restrict__ qt, const int* __restrict__ qy,
                  const int* __restrict__ qx, const int* __restrict__ sy,
                  const int* __restrict__ sx, int S, int dt_lo, int pt,
                  int ps, int w_s, int base_row, int hp_g, int wp_g,
                  float* __restrict__ out) {
  extern __shared__ float smem[];
  const int R = w_s + ps - 1;
  const int cp = pt * C;
  const int rr = R * R, pp = ps * ps, ws2 = w_s * w_s;
  float* reg = smem;             // (cp, R, R) candidate region
  float* qry = smem + cp * rr;   // (cp, ps, ps) query patch
  const int half = (w_s - 1) / 2;
  const int dti = blockIdx.y;
  const int dt = dt_lo + dti;
  const size_t hw = (size_t)H * W;
  const int s_begin = blockIdx.x * kSitesPerBlock;
  const int s_end = min(s_begin + kSitesPerBlock, S);

  for (int s = s_begin; s < s_end; ++s) {
    const int t = qt[s], y = qy[s], x = qx[s];
    const size_t ds = (size_t)dti * S + s;
    const int y0 = sy ? sy[ds] : y - half, x0 = sx ? sx[ds] : x - half;
    for (int e = threadIdx.x; e < cp * pp; e += blockDim.x) {
      const int k = e / pp, r = e - k * pp;
      const int f = k / C, c = k - f * C;
      const int tt = t + f, yy = y + r / ps, xx = x + r % ps;
      float v = 0.f;
      if (tt >= 0 && tt < T && yy >= 0 && yy < H && xx >= 0 && xx < W)
        v = vid[((size_t)tt * C + c) * hw + (size_t)yy * W + xx];
      qry[e] = v;
    }
    for (int e = threadIdx.x; e < cp * rr; e += blockDim.x) {
      const int k = e / rr, r = e - k * rr;
      const int f = k / C, c = k - f * C;
      const int tt = t + dt + f, yy = y0 + r / R, xx = x0 + r % R;
      float v = 0.f;
      if (tt >= 0 && tt < T && yy >= 0 && yy < H && xx >= 0 && xx < W)
        v = vid[((size_t)tt * C + c) * hw + (size_t)yy * W + xx];
      reg[e] = v;
    }
    __syncthreads();
    for (int o = threadIdx.x; o < ws2; o += blockDim.x) {
      const int a = o / w_s, b = o - a * w_s;
      if (kTile) {
        const int cy = y0 + a + base_row, cx = x0 + b;
        if (cy < 0 || cy > hp_g - 1 || cx < 0 || cx > wp_g - 1) {
          out[ds * ws2 + o] = __int_as_float(0x7f800000);  // +inf
          continue;
        }
      }
      float acc = 0.f;
      for (int k = 0; k < cp; ++k) {
        const float* q = qry + k * pp;
        const float* g = reg + k * rr + a * R + b;
        for (int i = 0; i < ps; ++i) {
          for (int j = 0; j < ps; ++j) {
            const float d = q[i * ps + j] - g[i * R + j];
            acc = fmaf(d, d, acc);
          }
        }
      }
      out[ds * ws2 + o] = acc;
    }
    __syncthreads();
  }
}

template <bool kTile>
int launch(const float* vid, int T, int C, int H, int W, const int* qt,
           const int* qy, const int* qx, const int* sy, const int* sx, int S,
           int dt_lo, int n_dt, int pt, int ps, int w_s, int base_row,
           int hp_g, int wp_g, float* out, void* stream) {
  if (S <= 0 || n_dt <= 0) return 0;
  const int R = w_s + ps - 1;
  const size_t smem = (size_t)pt * C * (R * R + ps * ps) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        patch_dist_kernel<kTile>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((S + kSitesPerBlock - 1) / kSitesPerBlock, n_dt);
  patch_dist_kernel<kTile><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      vid, T, C, H, W, qt, qy, qx, sy, sx, S, dt_lo, pt, ps, w_s, base_row,
      hp_g, wp_g, out);
  return (int)cudaGetLastError();
}

}  // namespace

// vid: (T, C, H, W) f32; qt/qy/qx: (S,) int32 query corners; sy/sx: null,
// or (n_dt, S) int32 window starts; out: (n_dt, S, w_s*w_s) f32 for
// dt = dt_lo .. dt_lo+n_dt-1.
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
