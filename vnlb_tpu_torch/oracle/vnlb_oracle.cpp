// C++ reference oracle for the TPU-native VNLB framework.
//
// Role: the reference implementation relied on an *external* SWIG-wrapped
// C++ package (svnlb) as its correctness oracle (reference
// tests/test_gpu_sim_search.py:24-26; SURVEY.md §2.2 N6).  This file is the
// new framework's in-repo equivalent: a small, sequential, double-precision
// C++ implementation of every compute op (search, gather, Bayes filter,
// aggregation, color transform) with EXACTLY the semantics documented in
// vnlb_tpu/ops/*.py, exposed through a C ABI for ctypes.
//
// It is used only by tests (oracle parity), never on the TPU path.
//
// Build: g++ -O2 -shared -fPIC -o libvnlb_oracle.so vnlb_oracle.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
inline double clampd(double v, double lo, double hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
inline int round_half_up(double x) { return (int)std::floor(x + 0.5); }

struct Vid {
  const float* p;
  int T, C, H, W;
  inline float at(int t, int c, int y, int x) const {
    return p[((t * C + c) * H + y) * W + x];
  }
};

// 2x average pooling (needle pyramid level), matches ops/search.py _avg_pool2
std::vector<float> avg_pool2(const std::vector<float>& v, int T, int C, int H,
                             int W, int* H2, int* W2) {
  *H2 = H / 2;
  *W2 = W / 2;
  std::vector<float> out((size_t)T * C * (*H2) * (*W2));
  for (int t = 0; t < T; t++)
    for (int c = 0; c < C; c++)
      for (int y = 0; y < *H2; y++)
        for (int x = 0; x < *W2; x++) {
          double s = 0;
          for (int dy = 0; dy < 2; dy++)
            for (int dx = 0; dx < 2; dx++)
              s += v[((size_t)(t * C + c) * H + 2 * y + dy) * W + 2 * x + dx];
          out[((size_t)(t * C + c) * (*H2) + y) * (*W2) + x] = (float)(s / 4.0);
        }
  return out;
}

// Track flow centers for one site; fills cy/cx[n_dt] (frame ascending),
// matching ops/search.py track_centers.
void track_one(const Vid& fflow, const Vid& bflow, int T, int H, int W, int tq,
               int yq, int xq, int nwt_b, int nwt_f, int* cys, int* cxs) {
  int n_dt = nwt_b + nwt_f + 1;
  std::vector<double> cy(n_dt), cx(n_dt);
  cy[nwt_b] = yq;
  cx[nwt_b] = xq;
  double y = yq, x = xq;
  for (int i = 0; i < nwt_f; i++) {
    int fi = clampi(tq + i, 0, T - 1);
    int yi = clampi(round_half_up(y), 0, H - 1);
    int xi = clampi(round_half_up(x), 0, W - 1);
    double u = fflow.at(fi, 0, yi, xi), v = fflow.at(fi, 1, yi, xi);
    y = clampd(y + v, 0, H - 1);
    x = clampd(x + u, 0, W - 1);
    cy[nwt_b + 1 + i] = y;
    cx[nwt_b + 1 + i] = x;
  }
  y = yq;
  x = xq;
  for (int i = 0; i < nwt_b; i++) {
    int fi = clampi(tq - i, 0, T - 1);
    int yi = clampi(round_half_up(y), 0, H - 1);
    int xi = clampi(round_half_up(x), 0, W - 1);
    double u = bflow.at(fi, 0, yi, xi), v = bflow.at(fi, 1, yi, xi);
    y = clampd(y + v, 0, H - 1);
    x = clampd(x + u, 0, W - 1);
    cy[nwt_b - 1 - i] = y;
    cx[nwt_b - 1 - i] = x;
  }
  for (int i = 0; i < n_dt; i++) {
    cys[i] = round_half_up(cy[i]);
    cxs[i] = round_half_up(cx[i]);
  }
}

// Jacobi eigendecomposition of a symmetric n x n matrix (double).
// Eigenvalues descending in w[], eigenvectors in columns of V (n x n,
// row-major: V[i*n+j] = component i of eigenvector j).
void jacobi_eigh(std::vector<double>& A, int n, std::vector<double>& w,
                 std::vector<double>& V) {
  V.assign((size_t)n * n, 0.0);
  for (int i = 0; i < n; i++) V[(size_t)i * n + i] = 1.0;
  const int max_sweeps = 64;
  for (int sweep = 0; sweep < max_sweeps; sweep++) {
    double off = 0;
    for (int p = 0; p < n; p++)
      for (int q = p + 1; q < n; q++) off += A[(size_t)p * n + q] * A[(size_t)p * n + q];
    if (off < 1e-22) break;
    for (int p = 0; p < n; p++)
      for (int q = p + 1; q < n; q++) {
        double apq = A[(size_t)p * n + q];
        if (std::fabs(apq) < 1e-300) continue;
        double app = A[(size_t)p * n + p], aqq = A[(size_t)q * n + q];
        double tau = (aqq - app) / (2 * apq);
        double t = (tau >= 0 ? 1.0 : -1.0) /
                   (std::fabs(tau) + std::sqrt(1 + tau * tau));
        double c = 1.0 / std::sqrt(1 + t * t), s = t * c;
        for (int k = 0; k < n; k++) {
          double akp = A[(size_t)k * n + p], akq = A[(size_t)k * n + q];
          A[(size_t)k * n + p] = c * akp - s * akq;
          A[(size_t)k * n + q] = s * akp + c * akq;
        }
        for (int k = 0; k < n; k++) {
          double apk = A[(size_t)p * n + k], aqk = A[(size_t)q * n + k];
          A[(size_t)p * n + k] = c * apk - s * aqk;
          A[(size_t)q * n + k] = s * apk + c * aqk;
        }
        for (int k = 0; k < n; k++) {
          double vkp = V[(size_t)k * n + p], vkq = V[(size_t)k * n + q];
          V[(size_t)k * n + p] = c * vkp - s * vkq;
          V[(size_t)k * n + q] = s * vkp + c * vkq;
        }
      }
  }
  // sort descending
  std::vector<int> idx(n);
  for (int i = 0; i < n; i++) idx[i] = i;
  w.resize(n);
  std::sort(idx.begin(), idx.end(), [&](int a, int b) {
    return A[(size_t)a * n + a] > A[(size_t)b * n + b];
  });
  std::vector<double> V2((size_t)n * n);
  for (int j = 0; j < n; j++) {
    w[j] = A[(size_t)idx[j] * n + idx[j]];
    for (int i = 0; i < n; i++) V2[(size_t)i * n + j] = V[(size_t)i * n + idx[j]];
  }
  V.swap(V2);
}

// Distances for one site at one pyramid level; accumulates into dist[n_dt*ws*ws].
void level_dist_one(const Vid& vid, int tq, int yq, int xq, const int* cys,
                    const int* cxs, int ps, int pt, int c_d, int ws, int nwt_b,
                    int nwt_f, double norm, double* dist) {
  int T = vid.T, H = vid.H, W = vid.W;
  int half = (ws - 1) / 2;
  int n_dt = nwt_b + nwt_f + 1;
  int tq_c = clampi(tq, 0, T - pt);
  int yq_c = clampi(yq, 0, H - ps);
  int xq_c = clampi(xq, 0, W - ps);
  for (int di = 0; di < n_dt; di++) {
    int f = tq + (di - nwt_b);
    int fc = clampi(f, 0, T - pt);
    int sy = clampi(cys[di] - half, 0, std::max(H - ps - (ws - 1), 0));
    int sx = clampi(cxs[di] - half, 0, std::max(W - ps - (ws - 1), 0));
    for (int dy = 0; dy < ws; dy++)
      for (int dx = 0; dx < ws; dx++) {
        int y = std::min(sy + dy, H - ps);
        int x = std::min(sx + dx, W - ps);
        double d = 0;
        for (int p = 0; p < pt; p++)
          for (int c = 0; c < c_d; c++)
            for (int py = 0; py < ps; py++)
              for (int px = 0; px < ps; px++) {
                double a = vid.at(tq_c + p, c, yq_c + py, xq_c + px);
                double b = vid.at(fc + p, c, y + py, x + px);
                d += (a - b) * (a - b);
              }
        dist[((size_t)di * ws + dy) * ws + dx] += d / norm;
      }
  }
}

}  // namespace

extern "C" {

// In-place RGB->YUV / YUV->RGB with the exact C++ opponent weights
// (vnlb_tpu/ops/color.py).
void vnlb_rgb2yuv(float* v, int T, int C, int H, int W) {
  const double w0 = 1.0 / std::sqrt(3.0), w1 = 1.0 / std::sqrt(2.0),
               w2 = std::sqrt(2.0) * 2.0 / std::sqrt(3.0);
  size_t hw = (size_t)H * W;
  for (int t = 0; t < T; t++)
    for (size_t i = 0; i < hw; i++) {
      float* r = v + ((size_t)t * C + 0) * hw + i;
      float* g = v + ((size_t)t * C + 1) * hw + i;
      float* b = v + ((size_t)t * C + 2) * hw + i;
      double R = *r, G = *g, B = *b;
      *r = (float)(w0 * (R + G + B));
      *g = (float)(w1 * (R - B));
      *b = (float)(w2 * (0.25 * R - 0.5 * G + 0.25 * B));
    }
}

void vnlb_yuv2rgb(float* v, int T, int C, int H, int W) {
  const double w0 = 1.0 / std::sqrt(3.0), w1 = 1.0 / std::sqrt(2.0),
               w2 = std::sqrt(2.0) / std::sqrt(3.0);
  size_t hw = (size_t)H * W;
  for (int t = 0; t < T; t++)
    for (size_t i = 0; i < hw; i++) {
      float* y = v + ((size_t)t * C + 0) * hw + i;
      float* u = v + ((size_t)t * C + 1) * hw + i;
      float* q = v + ((size_t)t * C + 2) * hw + i;
      double Y = *y, U = *u, V2 = *q;
      *y = (float)(w0 * Y + w1 * U + w2 * 0.5 * V2);
      *u = (float)(w0 * Y - w2 * V2);
      *q = (float)(w0 * Y - w1 * U + w2 * 0.5 * V2);
    }
}

// Coverage lattice (vnlb_tpu/ops/mask.py semantics). mask: (T,H,W) uint8.
// Returns the number of sites.
int vnlb_lattice(uint8_t* mask, int T, int C, int H, int W, int ps, int pt,
                 int step) {
  (void)C;
  std::memset(mask, 0, (size_t)T * H * W);
  int end_t = T - pt + 1, end_h = H - ps + 1, end_w = W - ps + 1;
  int n = 0;
  for (int ti = 0; ti < end_t; ti++) {
    bool last_t = ti == end_t - 1;
    int phase_h = last_t ? 0 : ti;
    for (int hi = 0; hi < end_h; hi++) {
      bool take_h = (hi % step) == (phase_h % step);
      bool first_h = hi == 0, last_h = hi == end_h - 1;
      if (!(take_h || first_h || last_h)) continue;
      int phase_w = last_h ? 0 : phase_h + hi / step;
      for (int wi = 0; wi < end_w; wi++) {
        bool take_w = (wi % step) == (phase_w % step);
        if (take_w || wi == 0 || wi == end_w - 1) {
          mask[((size_t)ti * H + hi) * W + wi] = 1;
          n++;
        }
      }
    }
  }
  return n;
}

// Top-K space-time patch search (vnlb_tpu/ops/search.py semantics).
// video: (T,C,H,W) YUV float32. sites: (B,3) int32. flows: (T,2,H,W).
// vals: (B,K) float32 out; inds: (B,K) int32 out.
// needle_scales == 1 -> plain l2; > 1 -> pyramid accumulation.
void vnlb_search(const float* video, int T, int C, int H, int W,
                 const float* fflow, const float* bflow, const int* sites,
                 int nsites, int ps, int pt, int c_d, int ws, int nwt_b,
                 int nwt_f, int K, float offset, int needle_scales,
                 float* vals, int* inds) {
  Vid vid{video, T, C, H, W};
  Vid ff{fflow, T, 2, H, W}, bf{bflow, T, 2, H, W};
  int n_dt = nwt_b + nwt_f + 1;
  int ncand = n_dt * ws * ws;
  double norm = (double)pt * c_d * ps * ps * 255.0 * 255.0;

  // Pre-build pyramid levels.
  struct Level {
    std::vector<float> data;
    int H, W;
  };
  std::vector<Level> levels;
  {
    std::vector<float> cur(video, video + (size_t)T * C * H * W);
    int h = H, w = W;
    levels.push_back({cur, h, w});
    for (int s = 1; s < needle_scales; s++) {
      if (h / 2 < (ws + ps - 1) || w / 2 < (ws + ps - 1)) break;
      int h2, w2;
      std::vector<float> nxt = avg_pool2(levels.back().data, T, C, h, w, &h2, &w2);
      levels.push_back({nxt, h2, w2});
      h = h2;
      w = w2;
    }
  }

  std::vector<double> dist(ncand);
  std::vector<int> cys(n_dt), cxs(n_dt);
  std::vector<std::pair<double, int>> cand(ncand);  // (dist, enum index)

  for (int b = 0; b < nsites; b++) {
    int tq = sites[b * 3 + 0], yq = sites[b * 3 + 1], xq = sites[b * 3 + 2];
    track_one(ff, bf, T, H, W, tq, yq, xq, nwt_b, nwt_f, cys.data(), cxs.data());
    std::fill(dist.begin(), dist.end(), 0.0);

    for (size_t lv = 0; lv < levels.size(); lv++) {
      Vid lvid{levels[lv].data.data(), T, C, levels[lv].H, levels[lv].W};
      int sc = 1 << lv;
      int lyq = std::min(yq / sc, levels[lv].H - ps);
      int lxq = std::min(xq / sc, levels[lv].W - ps);
      std::vector<int> lcys(n_dt), lcxs(n_dt);
      for (int i = 0; i < n_dt; i++) {
        lcys[i] = std::min(cys[i] / sc, levels[lv].H - 1);
        lcxs[i] = std::min(cxs[i] / sc, levels[lv].W - 1);
      }
      level_dist_one(lvid, tq, lyq, lxq, lcys.data(), lcxs.data(), ps, pt, c_d,
                     ws, nwt_b, nwt_f, norm, dist.data());
    }

    // mask temporally-invalid frames, build candidates
    for (int di = 0; di < n_dt; di++) {
      int f = tq + (di - nwt_b);
      bool ok = f >= 0 && f <= T - pt;
      for (int j = 0; j < ws * ws; j++) {
        int ci = di * ws * ws + j;
        cand[ci] = {ok ? dist[ci] - offset : INFINITY, ci};
      }
    }
    std::stable_sort(cand.begin(), cand.end(),
                     [](const std::pair<double, int>& a,
                        const std::pair<double, int>& b) {
                       return a.first < b.first;
                     });
    int half = (ws - 1) / 2;
    for (int k = 0; k < K; k++) {
      double d = cand[k].first;
      int ci = cand[k].second;
      int di = ci / (ws * ws), rem = ci % (ws * ws);
      int dy = rem / ws, dx = rem % ws;
      int f = clampi(tq + (di - nwt_b), 0, T - pt);
      int sy = clampi(cys[di] - half, 0, std::max(H - ps - (ws - 1), 0));
      int sx = clampi(cxs[di] - half, 0, std::max(W - ps - (ws - 1), 0));
      int y = std::min(sy + dy, H - ps), x = std::min(sx + dx, W - ps);
      vals[(size_t)b * K + k] = (float)d;
      inds[(size_t)b * K + k] =
          std::isinf(d) ? -1 : f * (C * H * W) + y * W + x;
    }
  }
}

// Patch gather (vnlb_tpu/ops/gather.py semantics).
// out: (B,K,pt,C,ps,ps) float32.
void vnlb_fill_patches(const float* video, int T, int C, int H, int W,
                       const int* inds, int B, int K, int pt, int ps,
                       float* out) {
  Vid vid{video, T, C, H, W};
  int chw = C * H * W, hw = H * W;
  for (int b = 0; b < B; b++)
    for (int k = 0; k < K; k++) {
      int ind = inds[(size_t)b * K + k];
      int safe = ind < 0 ? 0 : ind;
      int f = clampi(safe / chw, 0, T - pt);
      int y = clampi((safe % hw) / W, 0, H - ps);
      int x = clampi(safe % W, 0, W - ps);
      float* dst = out + ((((size_t)b * K + k) * pt) * C) * ps * ps;
      for (int p = 0; p < pt; p++)
        for (int c = 0; c < C; c++)
          for (int py = 0; py < ps; py++)
            for (int px = 0; px < ps; px++)
              *dst++ = vid.at(f + p, c, y + py, x + px);
    }
}

// Flat-area flags (vnlb_tpu/ops/flat.py semantics). flags: (B,) uint8.
void vnlb_flat(const float* pnoisy, int B, int K, int pt, int c, int ps,
               double gamma, double sigma2, uint8_t* flags) {
  int pdim = pt * ps * ps;
  for (int b = 0; b < B; b++) {
    double vbar = 0;
    for (int ci = 0; ci < c; ci++) {
      double s = 0, s2 = 0;
      long z = (long)K * pdim;
      for (int k = 0; k < K; k++)
        for (int p = 0; p < pt; p++)
          for (int py = 0; py < ps; py++)
            for (int px = 0; px < ps; px++) {
              double v = pnoisy[((((size_t)b * K + k) * pt + p) * c + ci) *
                                    ps * ps +
                                py * ps + px];
              s += v;
              s2 += v * v;
            }
      vbar += (s2 - s * s / z) / (z - 1);
    }
    flags[b] = (vbar / c) < gamma * sigma2 ? 1 : 0;
  }
}

// Bayes/Wiener filter (vnlb_tpu/ops/bayes.py semantics), in place on pnoisy.
// pnoisy/pbasic: (B,K,pt,c,ps,ps).  use_basic_cov: cpatches == "basic".
void vnlb_bayes(float* pnoisy, const float* pbasic, const uint8_t* flat,
                int B, int K, int pt, int c, int ps, int rank, double sigma2,
                double sigmab2, double thresh, int step) {
  int p = pt * ps * ps;
  rank = std::min(rank, p);
  bool step2 = step == 1;
  bool use_basic_cov = step2;  // cpatches == "basic" in step 2 presets
  std::vector<double> xn((size_t)K * p), xb((size_t)K * p), cn(p), cb(p);
  std::vector<double> cov((size_t)p * p), w, V;

  auto idx6 = [&](int b, int k, int pi, int ci, int py, int px) {
    return ((((size_t)b * K + k) * pt + pi) * c + ci) * ps * ps + py * ps + px;
  };

  for (int b = 0; b < B; b++) {
    for (int ci = 0; ci < c; ci++) {
      // load (K, p) for this (b, ci)
      for (int k = 0; k < K; k++) {
        int q = 0;
        for (int pi = 0; pi < pt; pi++)
          for (int py = 0; py < ps; py++)
            for (int px = 0; px < ps; px++, q++) {
              xn[(size_t)k * p + q] = pnoisy[idx6(b, k, pi, ci, py, px)];
              if (step2) xb[(size_t)k * p + q] = pbasic[idx6(b, k, pi, ci, py, px)];
            }
      }
      // centers
      for (int q = 0; q < p; q++) {
        double s = 0;
        for (int k = 0; k < K; k++) s += xn[(size_t)k * p + q];
        cn[q] = s / K;
      }
      if (step2) {
        for (int q = 0; q < p; q++) {
          double s = 0;
          for (int k = 0; k < K; k++) s += xb[(size_t)k * p + q];
          cb[q] = s / K;
        }
        if (flat && flat[b]) for (int q = 0; q < p; q++) cn[q] = cb[q];
        for (int k = 0; k < K; k++)
          for (int q = 0; q < p; q++) xb[(size_t)k * p + q] -= cb[q];
      }
      for (int k = 0; k < K; k++)
        for (int q = 0; q < p; q++) xn[(size_t)k * p + q] -= cn[q];

      const std::vector<double>& xc = (step2 && use_basic_cov) ? xb : xn;
      // cov = X^T X / K
      for (int i = 0; i < p; i++)
        for (int j = i; j < p; j++) {
          double s = 0;
          for (int k = 0; k < K; k++)
            s += xc[(size_t)k * p + i] * xc[(size_t)k * p + j];
          cov[(size_t)i * p + j] = cov[(size_t)j * p + i] = s / K;
        }
      std::vector<double> A = cov;
      jacobi_eigh(A, p, w, V);
      // shrink + coefficients on top-rank
      std::vector<double> coeff(rank);
      for (int r = 0; r < rank; r++) {
        double lam = w[r] - std::min(w[r], sigmab2);
        coeff[r] = lam > thresh * sigma2 ? 1.0 / (1.0 + sigma2 / lam) : 0.0;
      }
      // xhat = (X U_r) (U_r * coeff)^T + center
      for (int k = 0; k < K; k++) {
        std::vector<double> z(rank, 0.0);
        for (int r = 0; r < rank; r++) {
          double s = 0;
          for (int q = 0; q < p; q++)
            s += xn[(size_t)k * p + q] * V[(size_t)q * p + r];
          z[r] = s * coeff[r];
        }
        int q = 0;
        for (int pi = 0; pi < pt; pi++)
          for (int py = 0; py < ps; py++)
            for (int px = 0; px < ps; px++, q++) {
              double s = 0;
              for (int r = 0; r < rank; r++) s += z[r] * V[(size_t)q * p + r];
              pnoisy[idx6(b, k, pi, ci, py, px)] = (float)(s + cn[q]);
            }
      }
    }
  }
}

// Aggregation (vnlb_tpu/ops/agg.py semantics).
// deno: (T,C,H,W) accumulator, weights: (T,H,W).
void vnlb_agg(const float* patches, const int* inds, const uint8_t* valid,
              int B, int K, int pt, int c, int ps, int T, int H, int W,
              float* deno, float* weights) {
  int chw = c * H * W, hw = H * W;
  for (int b = 0; b < B; b++)
    for (int k = 0; k < K; k++) {
      if (valid && !valid[(size_t)b * K + k]) continue;
      int ind = inds[(size_t)b * K + k];
      if (ind < 0) continue;
      int t0 = clampi(ind / chw, 0, T - pt);
      int y0 = clampi((ind % hw) / W, 0, H - ps);
      int x0 = clampi(ind % W, 0, W - ps);
      for (int p = 0; p < pt; p++)
        for (int py = 0; py < ps; py++)
          for (int px = 0; px < ps; px++) {
            for (int ci = 0; ci < c; ci++)
              deno[(((size_t)(t0 + p) * c + ci) * H + y0 + py) * W + x0 + px] +=
                  patches[((((size_t)b * K + k) * pt + p) * c + ci) * ps * ps +
                          py * ps + px];
            weights[((size_t)(t0 + p) * H + y0 + py) * W + x0 + px] += 1.0f;
          }
    }
}

}  // extern "C"
