"""The port's copy of the independent NumPy oracle
(vnlb_tpu/testing/npref.py), transliterated from the REFERENCE's Python
ops.

The C++ oracle (vnlb_tpu_torch/oracle/vnlb_oracle.cpp, driven by
``testing/oracle.py``) was written against the documented op semantics of
``vnlb_tpu``, so it cannot catch a misunderstanding that both share.  Every
function below instead encodes the semantics of the corresponding
*reference* Python implementation (file:line cited per function),
re-derived in plain float64 NumPy.  The functions, their signatures and
their bodies are those of ``vnlb_tpu.testing.npref`` (the tests pin the
outputs bitwise equal); this copy imports only numpy, so a machine without
jax (the one with the card) can hold the port to it.  Used by
``tests/test_torch_npref.py`` and ``chip_smoke.py``, never by a pass.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Color transform — reference lib/vnlb/utils/color.py:52-77 (rgb2yuv_cpp) and
# :31-50 (apply_yuv2rgb, the in-place inverse).
# ---------------------------------------------------------------------------

_SQ3 = 1.0 / np.sqrt(3.0)
_SQ2 = 1.0 / np.sqrt(2.0)
_SQ23 = np.sqrt(2.0) * 2.0 / np.sqrt(3.0)


def rgb2yuv(video: np.ndarray) -> np.ndarray:
    """(T, 3, H, W) RGB -> opponent YUV with the exact C++ weights."""
    r, g, b = video[:, 0], video[:, 1], video[:, 2]
    out = np.empty_like(video)
    out[:, 0] = _SQ3 * (r + g + b)
    out[:, 1] = _SQ2 * (r - b)
    out[:, 2] = _SQ23 * (0.25 * r - 0.5 * g + 0.25 * b)
    return out


def yuv2rgb(video: np.ndarray) -> np.ndarray:
    """Inverse transform (reference apply_yuv2rgb weights, color.py:31-50;
    note the inverse uses w2 = sqrt(2)/sqrt(3), half the forward w2)."""
    w0, w1, w2 = _SQ3, _SQ2, np.sqrt(2.0) / np.sqrt(3.0)
    y, u, v = video[:, 0], video[:, 1], video[:, 2]
    out = np.empty_like(video)
    out[:, 0] = w0 * y + w1 * u + w2 * 0.5 * v
    out[:, 1] = w0 * y - w2 * v
    out[:, 2] = w0 * y - w1 * u + w2 * 0.5 * v
    return out


# ---------------------------------------------------------------------------
# Coverage mask — reference lib/vnlb/search_mask/mask.py:252-288 (comp_params
# border math) + :315-358 (fill_mask strided phase-shifted lattice).
# Scalar loop on purpose: the reference's traversal order IS the contract.
# ---------------------------------------------------------------------------

def fill_mask(shape, ps: int, pt: int, w_s: int, n_dt: int, step_s: int
              ) -> np.ndarray:
    """(T, C, H, W) shape -> (T, H, W) bool coverage mask.

    All borders are "open" (origin 0 / ending full-size, the whole-image
    case of init_mask), so border_* are all False and the first/last
    rows/cols/frames are forced on.
    """
    t_len, _, h, w = shape
    end_t = t_len - pt + 1
    end_h = h - ps + 1
    end_w = w - ps + 1
    step_t = 1
    mask = np.zeros((t_len, h, w), dtype=bool)

    for ti in range(end_t):
        last_t = ti == end_t - 1
        if not (ti % step_t == 0 or last_t):
            continue
        phase_h = 0 if last_t else ti // step_t
        for hi in range(end_h):
            take_h = hi % step_s == phase_h % step_s
            edge_h = hi == 0 or hi == end_h - 1
            if not (take_h or edge_h):
                continue
            last_h = hi == end_h - 1
            phase_w = 0 if last_h else phase_h + hi // step_s
            for wi in range(end_w):
                take_w = wi % step_s == phase_w % step_s
                edge_w = wi == 0 or wi == end_w - 1
                if take_w or edge_w:
                    mask[ti, hi, wi] = True
    return mask


# ---------------------------------------------------------------------------
# Flat-area detection — reference lib/vnlb/utils/flat_areas.py:16-35.
# ---------------------------------------------------------------------------

def flat_areas(patches: np.ndarray, gamma: float, sigma2: float) -> np.ndarray:
    """(B, K, pt, c, ps, ps) noisy patches -> (B,) bool flat flags.

    Per-channel unbiased variance over all (K*pt*ps*ps) samples, averaged
    over channels, thresholded at gamma * sigma^2.
    """
    b, k, pt, c, ps, _ = patches.shape
    x = np.transpose(patches, (0, 3, 1, 2, 4, 5)).reshape(b, c, -1)
    z = x.shape[2]
    s1 = x.sum(axis=2)
    s2 = (x * x).sum(axis=2)
    var = (s2 - s1 * s1 / z) / (z - 1)
    return var.mean(axis=1) < gamma * sigma2


# ---------------------------------------------------------------------------
# Bayes / Wiener filter — reference lib/vnlb/deno/bayes_est.py:17-151.
# ---------------------------------------------------------------------------

def bayes_denoise(pnoisy: np.ndarray, pbasic, flat, *, step: int,
                  sigma2: float, sigmab2: float, rank: int, thresh: float,
                  cpatches: str = "noisy", mod_sel: str = "clipped"):
    """Reference Bayes filtering of one batch of patch groups.

    pnoisy/pbasic: (B, K, pt, c, ps, ps); flat: (B,) bool (step 2 only).
    Returns (filtered_noisy, rank_var) with filtered shape == pnoisy.
    """
    b, k, pt, c, ps, _ = pnoisy.shape
    p = pt * ps * ps
    rank = min(rank, p)

    # flat_pdim: b n pt c ph pw -> b c n (pt ph pw)   (bayes_est.py:69-71)
    def to_bcnp(x):
        return np.transpose(x, (0, 3, 1, 2, 4, 5)).reshape(b, c, k, p)

    xn = to_bcnp(np.asarray(pnoisy, np.float64))
    cnoisy = xn.mean(axis=2, keepdims=True)
    xb = cbasic = None
    if step == 1:
        xb = to_bcnp(np.asarray(pbasic, np.float64))
        cbasic = xb.mean(axis=2, keepdims=True)
        # flat groups use the basic center (bayes_est.py:96-99)
        fl = np.asarray(flat, bool)
        cnoisy = np.where(fl[:, None, None, None], cbasic, cnoisy)
        xb = xb - cbasic
    xn = xn - cnoisy

    src = xn if cpatches == "noisy" else xb
    src = src.reshape(b * c, k, p)
    xn2 = xn.reshape(b * c, k, p)

    # covariance + eigh, descending (bayes_est.py:112-126)
    cov = np.einsum("gkp,gkq->gpq", src, src) / k
    lam, u = np.linalg.eigh(cov)
    lam = lam[:, ::-1]
    u = u[:, :, ::-1][:, :, :rank]

    # rank_var BEFORE shrinkage: full spectrum sum, mean over c (:39-40)
    rank_var = lam.reshape(b, c, p).sum(axis=2).mean(axis=1)

    # "clipped" shrinkage on the top-rank values (:129-138)
    lam_r = lam[:, :rank].copy()
    if mod_sel == "clipped":
        lam_r -= np.minimum(lam_r, sigmab2)

    # Wiener gate (:140-144)
    gate = lam_r > thresh * sigma2
    coeff = np.where(gate, 1.0 / (1.0 + sigma2 / np.where(gate, lam_r, 1.0)),
                     0.0)

    # project (:146-151), re-center (:51-52)
    z = np.einsum("gkp,gpr->gkr", xn2, u)
    xf = np.einsum("gkr,gpr->gkp", z * coeff[:, None, :], u)
    out = xf.reshape(b, c, k, p) + cnoisy

    out = out.reshape(b, c, k, pt, ps, ps)
    out = np.transpose(out, (0, 2, 3, 1, 4, 5))
    return out, rank_var


# ---------------------------------------------------------------------------
# Aggregation — reference lib/vnlb/agg/comp_agg.py:106-141
# (exec_agg_simple_numba): serial scatter-add with bounds checks.
# ---------------------------------------------------------------------------

def agg_patches(deno: np.ndarray, weights: np.ndarray, patches: np.ndarray,
                inds: np.ndarray, ps: int, pt: int) -> None:
    """In-place scatter-add of (B, K, pt, c, ps, ps) patches at flat inds.

    deno: (T, C, H, W); weights: (T, H, W); inds: (B, K), -1 skipped.
    Index codec: ind = t*(C*H*W) + y*W + x (comp_agg.py:117-121).
    """
    t_len, c, h, w = deno.shape
    chw = c * h * w
    hw = h * w
    b, k = inds.shape
    for bi in range(b):
        for ki in range(k):
            ind = int(inds[bi, ki])
            if ind == -1:
                continue
            t0 = ind // chw
            y0 = (ind % hw) // w
            x0 = ind % w
            for f in range(pt):
                if not 0 <= t0 + f < t_len:
                    continue
                for dy in range(ps):
                    if not 0 <= y0 + dy < h:
                        continue
                    for dx in range(ps):
                        if not 0 <= x0 + dx < w:
                            continue
                        deno[t0 + f, :, y0 + dy, x0 + dx] += \
                            patches[bi, ki, f, :, dy, dx]
                        weights[t0 + f, y0 + dy, x0 + dx] += 1.0


# ---------------------------------------------------------------------------
# Pass epilogue — reference lib/vnlb/proc_nl.py:118-125.
# ---------------------------------------------------------------------------

def finalize(deno: np.ndarray, weights: np.ndarray, fallback: np.ndarray
             ) -> np.ndarray:
    """deno /= weights where covered; uncovered pixels from fallback."""
    gtz = weights > 0
    out = np.where(gtz[:, None], deno / np.where(gtz, weights, 1.0)[:, None],
                   fallback)
    return out
