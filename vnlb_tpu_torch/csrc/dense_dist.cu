// K3: dense candidate distances of the all-rows zero-flow search, for every
// pixel of a frame and every offset of the w_s x w_s window, one temporal
// offset dt per launch.
//
// Replaces the Pallas kernel vnlb_tpu/ops/pallas_dense.py:42 (`_kernel`,
// launched at pallas_dense.py:141 by `dense_distances_dt`).  For output
// frame f (only the frames whose candidate frame f+dt is valid, f in
// [f_lo, f_lo+n_f)), query corner (y, x) and offset delta = (a, b):
//   out[f-f_lo][y][x][a*w_s+b] = q2(y, x) + b2(y+a-half, x+b-half)
//       - 2 * sum_{p<pt*C, i<ps, j<ps} V_p[f](y+i, x+j)
//                                      * V_p[f+dt](y+a-half+i, x+b-half+j)
// with q2 / b2 the ps x ps box sums of the squared query / candidate
// planes, b2 = 0 where the candidate corner lies outside the frame, and
// zero read outside the frame (the zero padding of the TPU kernel's
// inputs).  Plane p of frame f is channel p % C of video frame f + p / C.
// The output is site-major: each corner's w_s^2 distances are one
// contiguous row, so the search takes a site's candidates as one row.
//
// What bounds it on the H100: the output write, n_f*H'*W'*w_s^2 f32
// (1.81 GB for a 5-frame 480x854 plane at w_s=15, 0.54 ms at 3.35 TB/s);
// the separable box needs ~2*pt*C + 2*(ps-1) + 3 f32 operations per value.
// The TPU kernel keeps a full-width row band in VMEM; a block here holds a
// 16 x 16 output tile with its halo (ps-1 + 2*half) of every plane in
// shared memory (59 KB at pt*C = 6, w_s = 15), computes q2 and b2 of the
// tile once, and gives each thread one offset delta: the thread sums the
// ps-wide row products of each column (rows shared by ps outputs, the
// separable box) and adds ps of them per output, so a warp writes 32
// consecutive distances of one corner (coalesced stores).  The candidate
// tiles' row pitch is congruent to w_s mod 32, so the lanes' reads at
// a*pitch + b fall in 32 distinct banks; the query reads are broadcasts.
// Each multiply-add still loads two shared-memory words, so the kernel is
// bound by shared-memory bandwidth, several times above the write bound;
// register tiling over neighbouring columns is left to a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileH = 16;  // output rows per block
constexpr int kTileW = 16;  // output columns per block

// smallest pitch >= width that is congruent to w_s modulo 32
__host__ __device__ inline int bank_pitch(int width, int w_s) {
  return width + (((w_s - width) % 32) + 32) % 32;
}

struct Layout {
  int qh, qw, dh, dw, dpitch, bh, bw, bpitch;
  size_t floats(int ptc) const {
    return (size_t)ptc * qh * qw + (size_t)ptc * dh * dpitch +
           (size_t)bh * bpitch + (size_t)kTileH * kTileW;
  }
};

__host__ __device__ inline Layout layout(int ps, int w_s) {
  const int half = (w_s - 1) / 2;
  Layout l;
  l.qh = kTileH + ps - 1;
  l.qw = kTileW + ps - 1;
  l.dh = l.qh + 2 * half;
  l.dw = l.qw + 2 * half;
  l.dpitch = bank_pitch(l.dw, w_s);
  l.bh = kTileH + 2 * half;
  l.bw = kTileW + 2 * half;
  l.bpitch = bank_pitch(l.bw, w_s);
  return l;
}

template <int PS>
__global__ void __launch_bounds__(kThreads)
dense_dist_kernel(const float* __restrict__ vid, int C, int H, int W, int pt,
                  int w_s, int dt, int f_lo, float* __restrict__ out) {
  extern __shared__ float smem[];
  const Layout l = layout(PS, w_s);
  const int half = (w_s - 1) / 2;
  const int ptc = pt * C;
  const int hp = H - PS + 1, wp = W - PS + 1;
  const int ws2 = w_s * w_s;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int fo = blockIdx.z, f = f_lo + fo;
  const int qplane = l.qh * l.qw, dplane = l.dh * l.dpitch;
  float* vq = smem;                    // (ptc, qh, qw) query tile
  float* vd = vq + ptc * qplane;       // (ptc, dh, dpitch) candidate tile
  float* b2 = vd + ptc * dplane;       // (bh, bpitch) candidate energies
  float* q2 = b2 + l.bh * l.bpitch;    // (kTileH, kTileW) query energies
  const size_t hw = (size_t)H * W;

  for (int e = threadIdx.x; e < ptc * qplane; e += blockDim.x) {
    const int k = e / qplane, r = e - k * qplane;
    const int fp = k / C, c = k - fp * C;
    const int yy = y0 + r / l.qw, xx = x0 + r % l.qw;
    float v = 0.f;
    if (yy < H && xx < W)
      v = vid[((size_t)(f + fp) * C + c) * hw + (size_t)yy * W + xx];
    vq[e] = v;
  }
  const int dsz = l.dh * l.dw;
  for (int e = threadIdx.x; e < ptc * dsz; e += blockDim.x) {
    const int k = e / dsz, r = e - k * dsz;
    const int fp = k / C, c = k - fp * C;
    const int ry = r / l.dw, rx = r - ry * l.dw;
    const int yy = y0 - half + ry, xx = x0 - half + rx;
    float v = 0.f;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W)
      v = vid[((size_t)(f + dt + fp) * C + c) * hw + (size_t)yy * W + xx];
    vd[k * dplane + ry * l.dpitch + rx] = v;
  }
  __syncthreads();

  for (int e = threadIdx.x; e < l.bh * l.bw; e += blockDim.x) {
    const int ry = e / l.bw, rx = e - ry * l.bw;
    const int gy = y0 - half + ry, gx = x0 - half + rx;
    float s = 0.f;
    if (gy >= 0 && gy < hp && gx >= 0 && gx < wp) {
      for (int k = 0; k < ptc; ++k) {
        const float* g = vd + k * dplane + ry * l.dpitch + rx;
        for (int i = 0; i < PS; ++i) {
#pragma unroll
          for (int j = 0; j < PS; ++j) s = fmaf(g[i * l.dpitch + j],
                                                g[i * l.dpitch + j], s);
        }
      }
    }
    b2[ry * l.bpitch + rx] = s;
  }
  for (int e = threadIdx.x; e < kTileH * kTileW; e += blockDim.x) {
    const int ry = e / kTileW, rx = e - ry * kTileW;
    float s = 0.f;
    for (int k = 0; k < ptc; ++k) {
      const float* q = vq + k * qplane + ry * l.qw + rx;
      for (int i = 0; i < PS; ++i) {
#pragma unroll
        for (int j = 0; j < PS; ++j) s = fmaf(q[i * l.qw + j],
                                              q[i * l.qw + j], s);
      }
    }
    q2[e] = s;
  }
  __syncthreads();

  const int ny = min(kTileH, hp - y0), nx = min(kTileW, wp - x0);
  for (int d = threadIdx.x; d < ws2; d += blockDim.x) {
    const int a = d / w_s, b = d - a * w_s;
    const float* vdd = vd + a * l.dpitch + b;
    const float* b2d = b2 + a * l.bpitch + b;
    for (int xc = 0; xc < nx; ++xc) {
      // h[r]: the ps-wide row products of tile row r at column xc
      float h[kTileH + PS - 1];
#pragma unroll
      for (int r = 0; r < kTileH + PS - 1; ++r) {
        float s = 0.f;
        for (int k = 0; k < ptc; ++k) {
          const float* q = vq + k * qplane + r * l.qw + xc;
          const float* g = vdd + k * dplane + r * l.dpitch + xc;
#pragma unroll
          for (int j = 0; j < PS; ++j) s = fmaf(q[j], g[j], s);
        }
        h[r] = s;
      }
      float* o = out + (((size_t)fo * hp + y0) * wp + x0 + xc) * ws2 + d;
#pragma unroll
      for (int y = 0; y < kTileH; ++y) {
        if (y < ny) {
          float cross = h[y];
#pragma unroll
          for (int i = 1; i < PS; ++i) cross += h[y + i];
          o[(size_t)y * wp * ws2] =
              q2[y * kTileW + xc] + b2d[y * l.bpitch + xc] - 2.f * cross;
        }
      }
    }
  }
}

template <int PS>
int launch(const float* vid, int C, int H, int W, int pt, int w_s, int dt,
           int f_lo, int n_f, float* out, cudaStream_t stream) {
  const Layout l = layout(PS, w_s);
  const size_t smem = l.floats(pt * C) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dense_dist_kernel<PS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int hp = H - PS + 1, wp = W - PS + 1;
  dim3 grid((wp + kTileW - 1) / kTileW, (hp + kTileH - 1) / kTileH, n_f);
  dense_dist_kernel<PS><<<grid, kThreads, smem, stream>>>(
      vid, C, H, W, pt, w_s, dt, f_lo, out);
  return (int)cudaGetLastError();
}

}  // namespace

// vid: (T, C, H, W) f32, the searched channels of one pyramid level; out:
// (n_f, H-ps+1, W-ps+1, w_s*w_s) f32 for frames f_lo .. f_lo+n_f-1, whose
// frames f+dt .. f+dt+pt-1 and f .. f+pt-1 must lie in [0, T).  ps is one
// of 3, 5, 7, 9 (the caller raises for others).
extern "C" int vnlb_dense_dist(const float* vid, int T, int C, int H, int W,
                               int pt, int ps, int w_s, int dt, int f_lo,
                               int n_f, float* out, void* stream) {
  if (n_f <= 0) return 0;
  if (f_lo < 0 || f_lo + dt < 0 || f_lo + n_f - 1 + pt - 1 >= T ||
      f_lo + n_f - 1 + dt + pt - 1 >= T || H < ps || W < ps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (ps) {
    case 3: return launch<3>(vid, C, H, W, pt, w_s, dt, f_lo, n_f, out, s);
    case 5: return launch<5>(vid, C, H, W, pt, w_s, dt, f_lo, n_f, out, s);
    case 7: return launch<7>(vid, C, H, W, pt, w_s, dt, f_lo, n_f, out, s);
    case 9: return launch<9>(vid, C, H, W, pt, w_s, dt, f_lo, n_f, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
