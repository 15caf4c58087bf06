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
// Above the write: at pt*C = 6 the shared-memory loads of the products, at
// pt*C = 1 the instruction slots of the box sums and of the stores.
//
// The design.  A block holds a tile_h x tile_w output tile with its halo
// (ps - 1 + w_s - 1 rows and columns) of every plane in shared memory and
// works in column strips of kNX outputs.  A work item is one (strip,
// offset delta) pair, and a thread takes one item at a time:
// * Sliding box in registers.  The thread walks the tile's rows top to
//   bottom.  For row r it forms the kNX + ps - 1 pixel products
//   P(r, x) = sum_p q*g once, takes the kNX horizontal ps-sums h(r, x) from
//   those registers into a ring of ps rows, and when row r completes
//   output row y = r - ps + 1 it adds the ring's ps rows in order
//   (h(y) + h(y+1) + ..., direct sums, no running-sum subtraction) and
//   writes the row's kNX distances.  Each pixel product is formed once per
//   offset: 22 rows * 14 products * 6 planes / 128 outputs = 14.4 FMAs an
//   output at stage 1 (tile_h 16, ps 7), where the one-column-at-a-time
//   kernel this replaces formed 57.75.
// * Loads.  The query tile's rows are padded to whole float4s and a
//   strip's query values load as float4 broadcasts (all lanes of a strip
//   share them): 4 + 14 loads for 14 FMAs a row and plane at ps 7.  The
//   candidate tile's row pitch is congruent to w_s mod 32, so the lanes'
//   reads at a*pitch + b fall in 32 distinct banks.  The tile is filled
//   by 4-byte cp.async copies, all of a thread's in flight at once (no
//   pipeline across tiles: with two blocks an SM, one block's fill
//   overlaps the other's arithmetic).
// * q2 and b2 by a separable box: row sums into shared memory, then
//   column sums, instead of ps^2 products a position.
// * Stores stream (st.global.cs): the plane is far beyond L2 and nothing
//   reads it back here.  (A branch-free predicated store in inline PTX
//   made stage 0 25% slower: 1.54 against 1.15 ms at s0.l0.)
// * Warps.  A strip's w_s^2 offsets are cut into whole warps of 32
//   consecutive offsets (a warp writes one 128-byte run of a corner) and
//   the strips' last w_s^2 mod 32 offsets are packed into tail warps.
//   Warp w takes whole warps w, w + 8, ... of strip 0, then of strip 1,
//   ..., so the block's warps finish a strip's corners together; the tail
//   warps go to the warps with fewer whole ones.  At w_s = 15: 7 whole
//   warps a strip and one tail warp of 4 lanes (one per strip), where 256
//   threads on 225 offsets left a warp with one live lane.  A tile at the
//   right edge skips its strips past the frame.
// * Tile.  tile_h is 16, chosen by measurement against 32 (NVIDIA H100
//   80GB HBM3, 700 W, scripts/torch_ab.py on a copy with kTileH = 32,
//   before the warp order and the fill took their final form, two runs
//   each: s1.l0 2.046 / 2.072 ms at 16 against 1.946 / 1.942 at
//   32, but s0.l0 1.280 / 1.255 against 1.391 / 1.398, s0.l1 0.365 /
//   0.370 against 0.395 / 0.416; a dense_rows="full" run launches 27
//   stage-0 planes to 7 of stage 1).  tile_w is the widest of 32, 16, 8
//   whose shared memory lets kMinBlocks blocks share an SM (w_s = 15: 32
//   at every stage; w_s = 27: 16 at stage 1, 106 / 101 KB); one block per
//   SM at tile_w 8 only where nothing else fits.
//
// `vnlb_dense_dist_plan` returns the launch plan (mirrored by
// ops/dense_dist.plan) and the blocks per SM the card grants it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;     // blocks per SM the design is built for
constexpr int kNX = 8;            // outputs of a column strip
constexpr int kTileH = 16;        // output rows of a tile
constexpr int kTileW[] = {32, 16, 8};
constexpr int kSmSmem = 233472;   // shared memory of an SM (228 KB)
constexpr int kBlockSmem = 232448;  // most a block may take (227 KB)
constexpr int kReserved = 1024;   // the system's share per resident block

// smallest pitch >= width that is congruent to w_s modulo 32
inline int bank_pitch(int width, int w_s) {
  return width + (((w_s - width) % 32) + 32) % 32;
}

inline int round4(int n) { return (n + 3) / 4 * 4; }

// The shared-memory layout of a tile and the launch that goes with it.
// Regions, in floats, each starting on a float4: the query tile (ptc,
// qrows, qpitch), the candidate tile (ptc, drows, dpitch), b2 (bh,
// bpitch), q2 (tile_h, tile_w), the candidate row sums (drows, bw), the
// query row sums (qrows, tile_w).
struct Plan {
  int th, tw, strips, items, full, tail_tasks, tasks, qrows, qpitch, drows,
      dw, dpitch, bh, bw, bpitch, smem, blocks, gx, gy, gz;
  int q_off, d_off, b2_off, q2_off, rg_off, rq_off;
};

inline Plan tile_plan(int ps, int w_s, int ptc, int th, int tw) {
  Plan p{};
  p.th = th;
  p.tw = tw;
  p.strips = tw / kNX;
  p.items = p.strips * w_s * w_s;
  // each strip's offsets in whole warps, then the strips' w_s^2 mod 32
  // last offsets packed into tail warps
  p.full = w_s * w_s / 32;
  p.tail_tasks = (p.strips * (w_s * w_s - 32 * p.full) + 31) / 32;
  p.tasks = p.strips * p.full + p.tail_tasks;
  p.qrows = th + ps - 1;
  // a strip's kNX + ps - 1 query values load as whole float4s
  p.qpitch = tw - kNX + round4(kNX + ps - 1);
  // the window's w_s - 1 rows and columns beyond the query tile
  p.drows = p.qrows + w_s - 1;
  p.dw = tw + ps - 1 + w_s - 1;
  p.dpitch = bank_pitch(p.dw, w_s);
  p.bh = th + w_s - 1;
  p.bw = tw + w_s - 1;
  p.bpitch = bank_pitch(p.bw, w_s);
  p.q_off = 0;
  p.d_off = p.q_off + round4(ptc * p.qrows * p.qpitch);
  p.b2_off = p.d_off + round4(ptc * p.drows * p.dpitch);
  p.q2_off = p.b2_off + round4(p.bh * p.bpitch);
  p.rg_off = p.q2_off + round4(th * tw);
  p.rq_off = p.rg_off + round4(p.drows * p.bw);
  p.smem = (p.rq_off + round4(p.qrows * tw)) * (int)sizeof(float);
  const int fit = kSmSmem / (p.smem + kReserved);
  p.blocks = fit < kMinBlocks ? fit : kMinBlocks;
  return p;
}

// The widest tile whose shared memory lets kMinBlocks blocks share an SM,
// else the narrowest if one block fits; blocks = 0 when none fits.
Plan make_plan(int ps, int w_s, int ptc, int H, int W, int n_f) {
  Plan p{};
  for (int tw : kTileW) {
    p = tile_plan(ps, w_s, ptc, kTileH, tw);
    if (p.blocks >= kMinBlocks) break;
  }
  if (p.smem > kBlockSmem) p.blocks = 0;
  const int hp = H - ps + 1, wp = W - ps + 1;
  p.gx = (wp + p.tw - 1) / p.tw;
  p.gy = (hp + p.th - 1) / p.th;
  p.gz = n_f;
  return p;
}

// A 4-byte cp.async into shared memory; zero-filled (src not read) when
// !ok.
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

// The kNX + PS - 1 products P(x) = sum_k q_k(x) * g_k(x) of one row: q from
// the query row (float4 broadcasts), g from the candidate row.
template <int PS>
__device__ __forceinline__ void row_products(const float* __restrict__ q,
                                             const float* __restrict__ g,
                                             int ptc, int qplane, int dplane,
                                             float (&p)[kNX + PS - 1]) {
  constexpr int NP = kNX + PS - 1;
  constexpr int NQ4 = (NP + 3) / 4;
#pragma unroll
  for (int v = 0; v < NQ4; ++v) {
    const float4 qv = reinterpret_cast<const float4*>(q)[v];
    const float qs[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * v + e < NP) p[4 * v + e] = qs[e] * g[4 * v + e];
  }
  for (int k = 1; k < ptc; ++k) {
    q += qplane;
    g += dplane;
#pragma unroll
    for (int v = 0; v < NQ4; ++v) {
      const float4 qv = reinterpret_cast<const float4*>(q)[v];
      const float qs[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * v + e < NP) p[4 * v + e] = fmaf(qs[e], g[4 * v + e],
                                                p[4 * v + e]);
    }
  }
}

template <int PS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dense_dist_kernel(const float* __restrict__ vid, int C, int H, int W, int pt,
                  int w_s, int dt, int f_lo, Plan pl,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int half = (w_s - 1) / 2;
  const int ptc = pt * C;
  const int hp = H - PS + 1, wp = W - PS + 1;
  const int ws2 = w_s * w_s;
  const int x0 = blockIdx.x * pl.tw, y0 = blockIdx.y * pl.th;
  const int fo = blockIdx.z, f = f_lo + fo;
  const int qplane = pl.qrows * pl.qpitch, dplane = pl.drows * pl.dpitch;
  float* vq = smem + pl.q_off;
  float* vd = smem + pl.d_off;
  float* b2 = smem + pl.b2_off;
  float* q2 = smem + pl.q2_off;
  float* rg = smem + pl.rg_off;
  float* rq = smem + pl.rq_off;
  const size_t hw = (size_t)H * W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // ---- fill: one warp per (plane, row), lanes along the row; every
  // copy of the thread in flight at once ----
  for (int kr = warp; kr < ptc * pl.qrows; kr += kWarps) {
    const int k = kr / pl.qrows, r = kr - k * pl.qrows;
    const int fp = k / C, c = k - fp * C, yy = y0 + r;
    const bool row_ok = yy < H;
    const float* src = vid + ((size_t)(f + fp) * C + c) * hw +
                       (size_t)(row_ok ? yy : 0) * W;
    float* dst = vq + k * qplane + r * pl.qpitch;
    for (int x = lane; x < pl.qpitch; x += 32) {
      const int xx = x0 + x;
      const bool ok = row_ok && xx < W;
      copy4(dst + x, src + (ok ? xx : 0), ok);
    }
  }
  for (int kr = warp; kr < ptc * pl.drows; kr += kWarps) {
    const int k = kr / pl.drows, r = kr - k * pl.drows;
    const int fp = k / C, c = k - fp * C, yy = y0 - half + r;
    const bool row_ok = yy >= 0 && yy < H;
    const float* src = vid + ((size_t)(f + dt + fp) * C + c) * hw +
                       (size_t)(row_ok ? yy : 0) * W;
    float* dst = vd + k * dplane + r * pl.dpitch;
    for (int x = lane; x < pl.dw; x += 32) {
      const int xx = x0 - half + x;
      const bool ok = row_ok && xx >= 0 && xx < W;
      copy4(dst + x, src + (ok ? xx : 0), ok);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // ---- q2 and b2: row sums of the squares, then column sums ----
  for (int e = threadIdx.x; e < pl.drows * pl.bw; e += kThreads) {
    const int r = e / pl.bw, x = e - r * pl.bw;
    const float* g = vd + r * pl.dpitch + x;
    float s = 0.f;
    for (int k = 0; k < ptc; ++k, g += dplane) {
#pragma unroll
      for (int j = 0; j < PS; ++j) s = fmaf(g[j], g[j], s);
    }
    rg[e] = s;
  }
  for (int e = threadIdx.x; e < pl.qrows * pl.tw; e += kThreads) {
    const int r = e / pl.tw, x = e - r * pl.tw;
    const float* q = vq + r * pl.qpitch + x;
    float s = 0.f;
    for (int k = 0; k < ptc; ++k, q += qplane) {
#pragma unroll
      for (int j = 0; j < PS; ++j) s = fmaf(q[j], q[j], s);
    }
    rq[e] = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < pl.bh * pl.bw; e += kThreads) {
    const int y = e / pl.bw, x = e - y * pl.bw;
    const int gy = y0 - half + y, gx = x0 - half + x;
    float s = 0.f;
    if (gy >= 0 && gy < hp && gx >= 0 && gx < wp) {
#pragma unroll
      for (int i = 0; i < PS; ++i) s += rg[(y + i) * pl.bw + x];
    }
    b2[y * pl.bpitch + x] = s;
  }
  for (int e = threadIdx.x; e < pl.th * pl.tw; e += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < PS; ++i) s += rq[e + i * pl.tw];
    q2[e] = s;
  }
  __syncthreads();

  // ---- distances: one (strip, offset) item a thread at a time.  Warp w
  // takes chunks w, w + kWarps, ... of 32 offsets of strip 0, then of
  // strip 1, ..., so the warps finish a strip's corners together; then
  // the tail tasks (w - full) mod kWarps, +kWarps, ... ----
  const int ny = min(pl.th, hp - y0), nx = min(pl.tw, wp - x0);
  const int rows = ny + PS - 1;
  const int tl = ws2 - 32 * pl.full;
  const int per = warp < pl.full ? (pl.full - warp + kWarps - 1) / kWarps : 0;
  const int n_full = pl.strips * per;
  const int t0 = ((warp - pl.full) % kWarps + kWarps) % kWarps;
  const int n_tail =
      t0 < pl.tail_tasks ? (pl.tail_tasks - t0 + kWarps - 1) / kWarps : 0;
  const size_t row_stride = (size_t)wp * ws2;
  for (int task = 0; task < n_full + n_tail; ++task) {
    int s, d;
    if (task < n_full) {
      s = task / per;
      d = 32 * (warp + kWarps * (task - s * per)) + lane;
    } else {
      const int it = 32 * (t0 + kWarps * (task - n_full)) + lane;
      if (it >= pl.strips * tl) continue;
      s = it / tl;
      d = 32 * pl.full + it - s * tl;
    }
    if (s * kNX >= nx) continue;
    const int a = d / w_s, b = d - a * w_s, xs = s * kNX;
    const int nxs = min(kNX, nx - xs);
    const float* q_s = vq + xs;
    const float* g_s = vd + a * pl.dpitch + b + xs;
    const float* b2_s = b2 + a * pl.bpitch + b + xs;
    const float* q2_s = q2 + xs;
    float* o_s = out + (((size_t)fo * hp + y0) * wp + x0 + xs) * ws2 + d;
    float hr[PS][kNX];  // ring: the horizontal sums of the last PS rows
    for (int r0 = 0; r0 < rows; r0 += PS) {
#pragma unroll
      for (int u = 0; u < PS; ++u) {
        const int r = r0 + u;  // r % PS == u
        if (r < rows) {
          float p[kNX + PS - 1];
          row_products<PS>(q_s + r * pl.qpitch, g_s + r * pl.dpitch, ptc,
                           qplane, dplane, p);
#pragma unroll
          for (int x = 0; x < kNX; ++x) {
            float h = p[x];
#pragma unroll
            for (int j = 1; j < PS; ++j) h += p[x + j];
            hr[u][x] = h;
          }
          if (r >= PS - 1) {
            const int y = r - PS + 1;  // rows y .. r sit in ring slots
                                       // (u + 1) % PS, (u + 2) % PS, ...
            const float4* q2v =
                reinterpret_cast<const float4*>(q2_s + y * pl.tw);
            float q2r[kNX];
#pragma unroll
            for (int v = 0; v < kNX / 4; ++v) {
              const float4 t = q2v[v];
              q2r[4 * v] = t.x;
              q2r[4 * v + 1] = t.y;
              q2r[4 * v + 2] = t.z;
              q2r[4 * v + 3] = t.w;
            }
            float* o = o_s + (size_t)y * row_stride;
#pragma unroll
            for (int x = 0; x < kNX; ++x, o += ws2) {
              float cross = hr[(u + 1) % PS][x];
#pragma unroll
              for (int i = 1; i < PS; ++i) cross += hr[(u + 1 + i) % PS][x];
              // (q2 + b2) - 2 cross, one rounding: 2 cross is exact
              const float v =
                  fmaf(-2.f, cross, q2r[x] + b2_s[y * pl.bpitch + x]);
              if (x < nxs) __stcs(o, v);
            }
          }
        }
      }
    }
  }
}

const void* kernel_for(int ps) {
  switch (ps) {
    case 3: return (const void*)dense_dist_kernel<3>;
    case 5: return (const void*)dense_dist_kernel<5>;
    case 7: return (const void*)dense_dist_kernel<7>;
    case 9: return (const void*)dense_dist_kernel<9>;
    default: return nullptr;
  }
}

template <int PS>
int launch(const float* vid, int C, int H, int W, int pt, int w_s, int dt,
           int f_lo, const Plan& pl, float* out, cudaStream_t stream) {
  if (pl.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dense_dist_kernel<PS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        pl.smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(pl.gx, pl.gy, pl.gz);
  dense_dist_kernel<PS><<<grid, kThreads, pl.smem, stream>>>(
      vid, C, H, W, pt, w_s, dt, f_lo, pl, out);
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
      f_lo + n_f - 1 + dt + pt - 1 >= T || H < ps || W < ps || w_s < 1)
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(ps, w_s, pt * C, H, W, n_f);
  if (pl.blocks < 1 || pl.gy > 65535 || pl.gz > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (ps) {
    case 3: return launch<3>(vid, C, H, W, pt, w_s, dt, f_lo, pl, out, s);
    case 5: return launch<5>(vid, C, H, W, pt, w_s, dt, f_lo, pl, out, s);
    case 7: return launch<7>(vid, C, H, W, pt, w_s, dt, f_lo, pl, out, s);
    case 9: return launch<9>(vid, C, H, W, pt, w_s, dt, f_lo, pl, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch plan of (ps, w_s, pt*C, H, W, n_f) into out[0..17], in the
// order of ops/dense_dist.PLAN_FIELDS (threads, tile rows, tile columns,
// strip width, strips, items, whole warps of a strip, tail warps, warp
// tasks, query pitch, candidate rows, candidate pitch, b2 pitch, shared
// bytes, blocks per SM of the design, grid x, y, z), then out[18] = the
// blocks per SM that the card grants the kernel at that plan.  Returns a
// cudaError_t (invalid value for an unsupported ps, or a shape whose tile
// does not fit an SM).
extern "C" int vnlb_dense_dist_plan(int ps, int w_s, int ptc, int H, int W,
                                    int n_f, int* out) {
  const void* fn = kernel_for(ps);
  if (fn == nullptr || w_s < 1 || ptc < 1 || H < ps || W < ps)
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(ps, w_s, ptc, H, W, n_f);
  if (pl.blocks < 1) return (int)cudaErrorInvalidValue;
  const int v[18] = {kThreads,  pl.th,      pl.tw,    kNX,
                     pl.strips, pl.items,   pl.full,  pl.tail_tasks,
                     pl.tasks,  pl.qpitch,  pl.drows, pl.dpitch,
                     pl.bpitch, pl.smem,    pl.blocks, pl.gx,
                     pl.gy,     pl.gz};
  for (int i = 0; i < 18; ++i) out[i] = v[i];
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                      pl.smem);
  out[18] = blocks;
  return (int)err;
}
