// K4: the patch-group gather at the top-K corners, straight from the video.
//
// Replaces the Pallas row gathers vnlb_tpu/ops/pallas_gather.py:176
// (`gather_rows`, the one `fill_patches_cols(use_pallas=True)` calls), :94
// (`gather_rows_padded`) and :146 (`gather_rows_tiled`).  Those copy rows of
// an unfolded (N, C*pt*ps*ps) patch-column arena with async DMAs; the arena
// exists because the TPU gathers ps-wide slices slowly.  Here each output
// row reads its patch from the (T, C, H, W) video directly, which gives the
// values of `fill_patches_cols` / `fill_patches_cols_joint`
// (vnlb_tpu/ops/gather.py:158-239) without building an arena.
//
// What it computes, for row r = (site b, candidate k), ind = inds[b][k]:
//   safe = max(ind, 0);  f = clip(safe / (C*H*W), 0, T-pt)
//   y = clip((safe % (H*W)) / W, 0, H-ps);  x = clip(safe % W, 0, W-ps)
//   out[r][c*pt*ps*ps + j*ps*ps + dy*ps + dx] = V[f+j, c, y+dy, x+dx]
// in the c-major row layout `bayes_denoise` reads.  With bf16 set, each
// value rounds to bf16 (nearest even) and back to f32, as the JAX bf16
// arena does.  Joint mode reads a second video at the same corners into a
// second output (the stage-1 noisy + basic take).  No arithmetic is done,
// so the result is bitwise equal to the plain PyTorch version.
//
// What bounds it on the H100: bytes.  Each row writes D = C*pt*ps^2 floats
// (588 B at stage 0, 1176 B per video at stage 1: 241 MB and 2 x 289 MB per
// 4096-site chunk) and reads as many from the video in ps-float runs.  The
// writes go to HBM; the reads overlap heavily (the candidates of one site
// and of its neighbours share pixels) and mostly hit L2.  The design keeps
// the writes coalesced and moves nothing else: a block takes kRows
// consecutive rows, decodes their corners and a per-lane offset table into
// shared memory once, then its threads walk the block's contiguous output
// span, so each warp stores 128 contiguous bytes.  The plain version's
// 64-bit (B, K, C, pt*ps*ps) index tensor (0.5-0.6 GB per chunk) is never
// built.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool kBf16, bool kJoint>
__global__ void __launch_bounds__(kThreads)
patch_gather_kernel(const float* __restrict__ v0,
                    const float* __restrict__ v1, int T, int C, int H, int W,
                    const int* __restrict__ inds, long long M, int pt, int ps,
                    float* __restrict__ o0, float* __restrict__ o1) {
  extern __shared__ long long smem[];
  const int D = C * pt * ps * ps;
  long long* base = smem;                                // (kRows,) corners
  int* off = reinterpret_cast<int*>(smem + kRows);       // (D,) lane offsets
  const long long r0 = (long long)blockIdx.x * kRows;
  const int nrows = (int)min((long long)kRows, M - r0);
  const int hw = H * W, chw = C * hw;
  const int pp = ps * ps, ppt = pt * pp;

  for (int i = threadIdx.x; i < nrows; i += blockDim.x) {
    const int safe = max(inds[r0 + i], 0);
    const int f = min(safe / chw, T - pt);
    const int y = min((safe % hw) / W, H - ps);
    const int x = min(safe % W, W - ps);
    base[i] = (long long)f * chw + (long long)y * W + x;
  }
  for (int l = threadIdx.x; l < D; l += blockDim.x) {
    const int c = l / ppt, q = l - c * ppt;
    const int j = q / pp, e = q - j * pp;
    const int dy = e / ps, dx = e - dy * ps;
    off[l] = (j * C + c) * hw + dy * W + dx;
  }
  __syncthreads();

  const int n = nrows * D;
  float* out0 = o0 + r0 * D;
  float* out1 = kJoint ? o1 + r0 * D : nullptr;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / D, l = e - r * D;
    const long long src = base[r] + off[l];
    float a = __ldg(v0 + src);
    if (kBf16) a = round_bf16(a);
    out0[e] = a;
    if (kJoint) {
      float b = __ldg(v1 + src);
      if (kBf16) b = round_bf16(b);
      out1[e] = b;
    }
  }
}

template <bool kBf16, bool kJoint>
int launch(const float* v0, const float* v1, int T, int C, int H, int W,
           const int* inds, long long M, int pt, int ps, float* o0,
           float* o1, cudaStream_t stream) {
  const int D = C * pt * ps * ps;
  const size_t smem = kRows * sizeof(long long) + (size_t)D * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        patch_gather_kernel<kBf16, kJoint>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (M + kRows - 1) / kRows;
  patch_gather_kernel<kBf16, kJoint><<<(unsigned)blocks, kThreads, smem,
                                        stream>>>(v0, v1, T, C, H, W, inds, M,
                                                  pt, ps, o0, o1);
  return (int)cudaGetLastError();
}

}  // namespace

// v0, v1: (T, C, H, W) f32 videos (v1 null outside joint mode); inds: (M,)
// int32 flat corner indices, -1 allowed; o0, o1: (M, C*pt*ps*ps) f32.
extern "C" int vnlb_patch_gather(const float* v0, const float* v1, int T,
                                 int C, int H, int W, const int* inds,
                                 long long M, int pt, int ps, int bf16,
                                 float* o0, float* o1, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool joint = v1 != nullptr;
  if (bf16)
    return joint ? launch<true, true>(v0, v1, T, C, H, W, inds, M, pt, ps,
                                      o0, o1, s)
                 : launch<true, false>(v0, v1, T, C, H, W, inds, M, pt, ps,
                                       o0, o1, s);
  return joint ? launch<false, true>(v0, v1, T, C, H, W, inds, M, pt, ps, o0,
                                     o1, s)
               : launch<false, false>(v0, v1, T, C, H, W, inds, M, pt, ps,
                                      o0, o1, s);
}
