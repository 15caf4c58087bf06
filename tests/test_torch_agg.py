"""Aggregation and gather parity of the PyTorch port against the JAX
package on the CPU: agg_rows + fold + finalize_img, inds_to_rows and the
patch gather."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vnlb_tpu.ops import agg as jagg
from vnlb_tpu.ops import gather as jgather

from vnlb_tpu_torch.ops import agg, gather
from vnlb_tpu_torch.ops.patch_gather import patch_gather
from vnlb_tpu_torch.pipeline import PLAIN

torch.set_num_threads(2)


def _inds(rng, shape, n, pt, ps):
    t_len, c, h, w = shape
    f = rng.integers(0, t_len - pt + 1, n)
    y = rng.integers(0, h - ps + 1, n)
    x = rng.integers(0, w - ps + 1, n)
    inds = (f * c * h * w + y * w + x).astype(np.int32)
    inds[rng.random(n) < 0.1] = -1
    return inds


@pytest.mark.parametrize("pt", [1, 2])
def test_agg_fold_finalize_match_jax(pt):
    rng = np.random.default_rng(pt)
    shape = (4, 3, 30, 34)
    t_len, c, h, w = shape
    ps = 7
    hp, wp = h - ps + 1, w - ps + 1
    b, k = 40, 12
    inds = _inds(rng, shape, b * k, pt, ps).reshape(b, k)
    # duplicate corners exercise the accumulation order
    inds[1] = inds[0]
    patches = rng.uniform(0, 255, (b, k, pt, c, ps, ps)).astype(np.float32)
    valid = (inds >= 0).astype(np.float32)
    rows_j = np.asarray(jgather.inds_to_rows(jnp.asarray(inds), shape, ps,
                                             pt))
    rows_t = gather.inds_to_rows(torch.from_numpy(inds), shape, ps,
                                 pt).numpy()
    np.testing.assert_array_equal(rows_t, rows_j)

    acc0 = np.zeros((t_len * hp * wp, pt * c * ps * ps + 1), np.float32)
    acc_j = jagg.agg_rows(jnp.asarray(acc0), jnp.asarray(patches),
                          jnp.asarray(rows_j[:, :, 0]), jnp.asarray(valid))
    acc_t = agg.agg_rows(torch.from_numpy(acc0.copy()),
                         torch.from_numpy(patches),
                         torch.from_numpy(rows_t[:, :, 0]),
                         torch.from_numpy(valid), PLAIN.scatter_rows)
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), rtol=1e-4,
                               atol=1e-3)

    dj, wj = jagg.fold(acc_j, pt, ps, shape)
    dt_, wt = agg.fold(acc_t, pt, ps, shape)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_allclose(dt_.numpy(), np.asarray(dj), rtol=1e-4,
                               atol=1e-2)

    fb = rng.uniform(0, 255, shape).astype(np.float32)
    out_j = np.asarray(jagg.finalize_img(dj, wj, jnp.asarray(fb)))
    out_t = agg.finalize_img(dt_, wt, torch.from_numpy(fb)).numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=1e-4, atol=1e-3)
    assert (np.asarray(wj) == 0).any()


def test_agg_repeat_is_bitwise():
    rng = np.random.default_rng(7)
    acc = torch.zeros((50, 8))
    rows = torch.from_numpy(rng.integers(0, 50, (30, 9)))
    patches = torch.from_numpy(rng.normal(size=(30, 9, 1, 1, 7, 1))
                               .astype(np.float32))
    wts = torch.ones((30, 9))
    a = agg.agg_rows(acc.clone(), patches, rows, wts, PLAIN.scatter_rows)
    b = agg.agg_rows(acc.clone(), patches, rows, wts, PLAIN.scatter_rows)
    assert torch.equal(a, b)


@pytest.mark.parametrize("pt,bf16", [(1, True), (2, True), (2, False)])
def test_gather_matches_jax(pt, bf16):
    rng = np.random.default_rng(3 + pt)
    shape = (5, 3, 26, 29)
    ps = 7
    video = rng.uniform(0, 255, shape).astype(np.float32)
    inds = _inds(rng, shape, 8 * 6, pt, ps).reshape(8, 6)
    want = np.asarray(jgather.fill_patches(jnp.asarray(video),
                                           jnp.asarray(inds), pt, ps))
    # (B, K, pt, c, ps, ps) -> c-major rows (B, K, c, pt*ps*ps)
    want = want.transpose(0, 1, 3, 2, 4, 5).reshape(8, 6, 3, -1)
    if bf16:
        want = np.asarray(jnp.asarray(want).astype(jnp.bfloat16)
                          .astype(jnp.float32))
    (got,) = patch_gather([torch.from_numpy(video)], torch.from_numpy(inds),
                          ps, pt, bf16)
    np.testing.assert_array_equal(got.numpy(), want)
