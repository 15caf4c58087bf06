"""Top-K modes of the port's dense search on the CPU.

* ``topk="stream"`` (a running top-K merged with each dt plane) is bitwise
  equal to ``"exact"`` on both dense branches (K1 lattice rows and K3 all
  rows), as tests/test_search_dense.py pins it in JAX;
* ``topk="approx"`` is the exact top-K in the port (``lax.approx_max_k``
  is exact off the TPU): bitwise equal to ``"exact"``, and to JAX's CPU
  output within one bf16 ulp per level with index swaps only at ties.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import vnlb_tpu.config as jcfg
from vnlb_tpu.ops.search_dense import exec_search_dense as j_search

from vnlb_tpu_torch.config import config_from_jax
from vnlb_tpu_torch.ops.mask import lattice_sites
from vnlb_tpu_torch.ops.search import search_levels
from vnlb_tpu_torch.ops.search_dense import exec_search_dense
from vnlb_tpu_torch.testing.data import add_noise, synthetic_video

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def clip():
    return add_noise(synthetic_video(4, 48, 52, seed=11), 20.0, seed=12)


def _cfg(stage, rows, topk="exact", **kw):
    return jcfg.default_config(20.0, border_mode="mask", dense_rows=rows,
                               topk=topk, **kw).stage(stage)


def _phases(shape, cfg):
    end_t = shape[0] - cfg.pt + 1
    return tuple((f % cfg.step_s) if f < end_t - 1 else 0
                 for f in range(end_t))


def _port(clip, jc):
    tc = config_from_jax(jc)
    sites = torch.from_numpy(lattice_sites(clip.shape, tc))
    v, i = exec_search_dense(torch.from_numpy(clip), sites, tc)
    return v.numpy(), i.numpy()


@pytest.mark.parametrize("rows", ["auto", "full"])
@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("mode", ["stream", "approx"])
def test_topk_mode_bitwise_equals_exact(clip, rows, stage, mode):
    v1, i1 = _port(clip, _cfg(stage, rows))
    v2, i2 = _port(clip, _cfg(stage, rows, topk=mode))
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(i1, i2)


def test_stream_with_fewer_candidates_than_k_is_exact(clip):
    """w_s^2 < K: JAX's stream mode falls back to the one-shot top-K."""
    kw = dict(w_s=5, npatches=40)
    v1, i1 = _port(clip, _cfg(1, "full", **kw))
    v2, i2 = _port(clip, _cfg(1, "full", topk="stream", **kw))
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(i1, i2)


@pytest.mark.parametrize("rows", ["auto", "full"])
@pytest.mark.parametrize("mode", ["stream", "approx"])
def test_topk_mode_matches_jax(clip, rows, mode):
    jc = _cfg(0, rows, topk=mode)
    sites = lattice_sites(clip.shape, config_from_jax(jc))
    jv, ji = j_search(jnp.asarray(clip), jnp.asarray(sites), jc,
                      qrow0=_phases(clip.shape, jc))
    jv, ji = np.asarray(jv), np.asarray(ji)
    tv, ti = _port(clip, jc)
    nlev = len(search_levels(torch.from_numpy(clip), config_from_jax(jc)))
    vtol = nlev * 2.0 ** -7 * (np.abs(jv) + jc.offset) + 1e-7
    err = np.abs(tv - jv)
    fin = np.isfinite(jv)
    assert np.array_equal(fin, np.isfinite(tv))
    assert (err[fin] <= vtol[fin]).all()
    # index swaps only at ties (bf16 rounding makes many exact ties, and
    # XLA's fused level sums move some values by an f32 ulp)
    diff = (ti != ji) & fin
    assert (err[diff] <= vtol[diff]).all()
