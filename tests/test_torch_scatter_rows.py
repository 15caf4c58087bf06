"""Kernel K6's arithmetic on the CPU: a NumPy mirror of its segment walk
against the ranked scatter, the ``Kernels`` field, ``agg_rows`` with the
plain version against the update rows and ranked scatter it replaced, and
the wrapper's dispatch and refusals.  The kernel itself runs only on the
card (tests/test_torch_cuda.py)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import vnlb_tpu_torch as vt
from vnlb_tpu_torch.ops import agg
from vnlb_tpu_torch.ops.scatter_rows import (patch_layout, scatter_rows,
                                             scatter_rows_kernel,
                                             scatter_rows_plain)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def _bf16(x):
    """float32 -> bf16 (round to nearest even) -> float32, finite x."""
    u = x.view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return r.astype(np.uint32).view(np.float32)


def segment_walk(acc, patches, wts, rows, bf16):
    """The kernel's walk: stable sort of the rows; each segment head reads
    its accumulator row once, adds the segment's update rows in sorted
    (original) order, one f32 add at a time, and writes the row once."""
    acc = acc.copy()
    b, ka = wts.shape
    prow = patches.reshape(b, patches.shape[1], -1)
    flat = rows.reshape(-1)
    perm = np.argsort(flat, kind="stable")
    srt = flat[perm]
    for i in range(flat.size):
        if i > 0 and srt[i] == srt[i - 1]:
            continue
        a = acc[srt[i]].copy()
        j = i
        while j < flat.size and srt[j] == srt[i]:
            site, k = divmod(int(perm[j]), ka)
            w = wts[site, k]
            u = np.append(prow[site, k] * w, w).astype(np.float32)
            a = a + (_bf16(u) if bf16 else u)
            j += 1
        acc[srt[i]] = a
    return acc


def _case(lanes, weights, seed, b=64, ka=8, k=10, n_rows=40):
    """Many duplicates: 512 updates over 40 rows."""
    rng = np.random.default_rng(seed)
    patches = rng.normal(100, 30, (b, k, lanes - 1)).astype(np.float32)
    rows = rng.integers(0, n_rows, (b, ka))
    if weights == "01":
        wts = (rng.random((b, ka)) < 0.8).astype(np.float32)
    else:
        wts = np.exp(-rng.uniform(0, 4, (b, ka))).astype(np.float32)
    acc = rng.normal(0, 50, (n_rows, lanes)).astype(np.float32)
    return acc, patches, wts, rows


def ranked(acc, patches, wts, rows, bf16):
    """The parent's ``agg_rows``: the (B*ka, L) update rows, then the
    ranked ``scatter_add_rows``."""
    acc = torch.from_numpy(acc.copy())
    b, ka = wts.shape
    vm = torch.from_numpy(wts)[:, :, None]
    p = torch.from_numpy(patches)[:, :ka].reshape(b, ka, -1)
    upd = torch.cat([p * vm, vm.expand(b, ka, 1)], dim=-1)
    if bf16:
        upd = upd.to(torch.bfloat16).to(torch.float32)
    agg.scatter_add_rows(acc, torch.from_numpy(rows).reshape(-1).long(),
                         upd.reshape(b * ka, -1))
    return acc


@pytest.mark.parametrize("weights", ["01", "exp"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("lanes", [148, 295])
def test_segment_walk_bitwise_ranked_scatter(lanes, bf16, weights):
    acc, patches, wts, rows = _case(lanes, weights, seed=lanes + bf16)
    want = ranked(acc, patches, wts, rows, bf16)
    got = segment_walk(acc, patches, wts, rows, bf16)
    np.testing.assert_array_equal(got.view(np.int32),
                                  want.numpy().view(np.int32))
    assert not np.array_equal(got, acc)


def test_kernels_carry_scatter_rows():
    assert vt.KERNELS.scatter_rows is scatter_rows
    assert vt.PLAIN.scatter_rows is scatter_rows_plain
    assert scatter_rows.__name__ == "scatter_rows"
    assert isinstance(scatter_rows.launches, int)


def _sorted(rows):
    return torch.sort(torch.from_numpy(rows).to(torch.int32).reshape(-1),
                      stable=True)


@pytest.mark.parametrize("bf16", [False, True])
def test_cpu_dispatch_is_the_plain_version(bf16):
    acc, patches, wts, rows = _case(148, "exp", seed=5)
    srt, perm = _sorted(rows)
    args = (torch.from_numpy(patches), torch.from_numpy(wts), srt, perm, bf16)
    got, want = torch.from_numpy(acc.copy()), torch.from_numpy(acc.copy())
    before = scatter_rows.launches
    scatter_rows(got, *args)
    scatter_rows_plain(want, *args)
    assert scatter_rows.launches == before
    assert torch.equal(got, want)
    assert torch.equal(got, ranked(acc, patches, wts, rows, bf16))


@pytest.mark.parametrize("pt", [1, 2])
@pytest.mark.parametrize("valid_dim", [1, 2])
def test_agg_rows_plain_is_the_parents_scatter(pt, valid_dim):
    """tests/test_torch_agg.py's inputs (duplicate corners, invalid
    entries), the patches given whole (K = 12 > ka = 9) as the pipeline
    gives the filter's output."""
    rng = np.random.default_rng(pt)
    t_len, c, h, w, ps = 4, 3, 30, 34, 7
    hp, wp = h - ps + 1, w - ps + 1
    b, k, ka = 40, 12, 9
    rows = rng.integers(0, t_len * hp * wp, (b, ka))
    rows[1] = rows[0]
    patches = rng.uniform(0, 255, (b, k, pt, c, ps, ps)).astype(np.float32)
    valid = rng.random((b, ka) if valid_dim == 2 else b) < 0.9
    acc0 = rng.uniform(0, 9, (t_len * hp * wp, pt * c * ps * ps + 1)) \
        .astype(np.float32)
    got = agg.agg_rows(torch.from_numpy(acc0.copy()),
                       torch.from_numpy(patches), torch.from_numpy(rows),
                       torch.from_numpy(valid), vt.PLAIN.scatter_rows)
    wts = np.broadcast_to(valid.reshape(b, -1), (b, ka)).astype(np.float32)
    assert torch.equal(got, ranked(acc0, patches, wts, rows, False))


def test_import_builds_nothing():
    code = ("import torch, vnlb_tpu_torch._build as b; "
            "import vnlb_tpu_torch.ops.scatter_rows; "
            "assert b.library.cache_info().currsize == 0; "
            "assert not torch.cuda.is_initialized()")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode == 0, res.stderr


def _args(**bad):
    acc, patches, wts, rows = _case(148, "01", seed=9)
    srt, perm = _sorted(rows)
    args = dict(acc=torch.from_numpy(acc), patches=torch.from_numpy(patches),
                wts=torch.from_numpy(wts), srt=srt, perm=perm)
    args.update(bad)
    return args


@pytest.mark.parametrize("bad", [
    dict(srt=torch.zeros(512, dtype=torch.int64)),
    dict(perm=torch.zeros(511, dtype=torch.int64)),
    dict(wts=torch.ones((64, 8), dtype=torch.float64)),
    dict(patches=torch.zeros((64, 7, 147))),
    dict(patches=torch.zeros((64, 10, 146))),
    dict(acc=torch.empty((2 ** 31, 148), device="meta")),
])
def test_wrapper_refuses(bad):
    with pytest.raises(ValueError):
        scatter_rows_plain(**_args(**bad))


def test_kernel_needs_cuda_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        scatter_rows_kernel(**_args())


@pytest.mark.parametrize("shape,perm", [
    ((6, 5, 1, 3, 7, 7), (0, 2, 3, 1, 4, 5)),    # the filter's c-major view
    ((6, 5, 2, 3, 7, 7), (0, 2, 3, 1, 4, 5)),
    ((6, 5, 2, 3, 7, 7), (0, 1, 2, 3, 4, 5)),    # contiguous
    ((6, 5, 13), (0, 1, 2)),
])
def test_patch_layout_addresses_every_lane(shape, perm):
    """The kernel's lane offsets (``patch_layout``) read each patch of a
    view of its storage in the patch's flat order."""
    inv = np.argsort(perm)
    base = torch.arange(float(np.prod(shape))).reshape(
        tuple(np.array(shape)[list(perm)]))
    view = base.permute(*inv)
    assert view.shape == shape
    dims, strides = patch_layout(view)
    lanes = np.arange(int(np.prod(dims)))
    idx, off = lanes, 0
    for n, t in zip(dims[::-1], strides[::-1]):
        off = off + (idx % n) * t
        idx = idx // n
    flat = base.reshape(-1)
    for b, k in ((0, 0), (5, 4), (3, 2)):
        start = b * view.stride(0) + k * view.stride(1)
        assert torch.equal(flat[start + torch.from_numpy(off)],
                           view[b, k].reshape(-1))
