"""Host-side spec of the PyTorch port pinned equal to the JAX package:
configs, the coverage lattice, the synthetic clips, the polyspec constants
and the colour transform.  Also: the port imports without jax."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import vnlb_tpu.config as jcfg
from vnlb_tpu.ops import color as jcolor
from vnlb_tpu.ops import mask as jmask
from vnlb_tpu.ops import polyspec as jpoly
from vnlb_tpu.testing import data as jdata

import vnlb_tpu_torch.config as tcfg
from vnlb_tpu_torch.ops import color as tcolor
from vnlb_tpu_torch.ops import mask as tmask
from vnlb_tpu_torch.ops import polyspec as tpoly
from vnlb_tpu_torch.testing import data as tdata

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("sigma", [10.0, 20.0, 40.0])
@pytest.mark.parametrize("preset", tcfg.PRESETS)
def test_default_config_matches_jax(preset, sigma):
    want = jcfg.default_config(sigma, preset=preset)
    got = tcfg.default_config(sigma, preset=preset)
    assert got == tcfg.config_from_jax(want)
    assert (got.sigma, got.preset, got.verbose) == (want.sigma, want.preset,
                                                    want.verbose)
    for stage in (0, 1):
        assert _fields(got.stage(stage)) == _fields(want.stage(stage))


def test_config_from_jax_stage_and_overrides():
    want = jcfg.default_config(20.0, step_s=6, border_mode="mask",
                               agg_k=[16, 32])
    got = tcfg.config_from_jax(want.stage(1))
    assert isinstance(got, tcfg.StageConfig)
    assert _fields(got) == _fields(want.stage(1))
    assert tcfg.default_config(20.0, step_s=6, border_mode="mask",
                               agg_k=[16, 32]) == tcfg.config_from_jax(want)
    assert [f.name for f in dataclasses.fields(tcfg.StageConfig)] == \
        [f.name for f in dataclasses.fields(jcfg.StageConfig)]
    with pytest.raises(ValueError):
        tcfg.default_config(20.0, preset="nope")


@pytest.mark.parametrize("stage,step_s,t_origin", [(0, 6, 0), (1, 6, 0),
                                                   (0, 3, 2), (1, 4, 1)])
def test_lattice_sites_match(stage, step_s, t_origin):
    cfg = tcfg.default_config(20.0).stage(stage).replace(step_s=step_s)
    jc = jcfg.default_config(20.0).stage(stage).replace(step_s=step_s)
    for shape in [(5, 3, 96, 112), (4, 3, 41, 57)]:
        np.testing.assert_array_equal(
            tmask.lattice_sites(shape, cfg, t_origin),
            jmask.lattice_sites(shape, jc, t_origin))


def test_synthetic_clip_and_noise_match():
    a = tdata.synthetic_video(5, 40, 52, seed=3)
    np.testing.assert_array_equal(a, jdata.synthetic_video(5, 40, 52, seed=3))
    np.testing.assert_array_equal(tdata.add_noise(a, 20.0, seed=1),
                                  jdata.add_noise(a, 20.0, seed=1))


@pytest.mark.parametrize("deg_f", [8, 12, 16, 24, 28, 32])
def test_polyspec_constants_match(deg_f):
    assert tpoly._ps_split(deg_f) == jpoly._ps_split(deg_f)
    m, s = tpoly._ps_split(deg_f)
    nodes = max(64, 2 * m * s)
    np.testing.assert_array_equal(tpoly._cheb_nodes(nodes),
                                  jpoly._cheb_nodes(nodes))
    np.testing.assert_array_equal(tpoly._dct_matrix(m * s, nodes),
                                  jpoly._dct_matrix(m * s, nodes))
    np.testing.assert_array_equal(tpoly._ps_basis_pinv(m, s, nodes),
                                  jpoly._ps_basis_pinv(m, s, nodes))
    for a, b in zip(tpoly._gram_maps(m, s, nodes),
                    jpoly._gram_maps(m, s, nodes)):
        np.testing.assert_array_equal(a, b)


def test_color_matches():
    rng = np.random.default_rng(0)
    v = rng.uniform(0, 255, (3, 3, 17, 19)).astype(np.float32)
    np.testing.assert_array_equal(tcolor.RGB2YUV, jcolor.RGB2YUV)
    np.testing.assert_array_equal(tcolor.YUV2RGB, jcolor.YUV2RGB)
    yuv = tcolor.rgb2yuv(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(yuv, np.asarray(jcolor.rgb2yuv(v)), atol=1e-4,
                               rtol=0)
    back = tcolor.yuv2rgb(torch.from_numpy(yuv)).numpy()
    np.testing.assert_allclose(back, np.asarray(jcolor.yuv2rgb(yuv)),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(back, v, atol=1e-3, rtol=0)


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['vnlb_tpu'] = None; "
            "import vnlb_tpu_torch, vnlb_tpu_torch.ops.search_dense, "
            "vnlb_tpu_torch.ops.econ_filter, vnlb_tpu_torch.testing.data, "
            "vnlb_tpu_torch.utils.metrics; "
            "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib', "
            "'vnlb_tpu.')) for m in sys.modules if sys.modules[m] is not None)")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
