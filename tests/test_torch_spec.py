"""Host-side spec of the PyTorch port pinned equal to the JAX package:
configs, the coverage lattice, the synthetic clips, the polyspec constants
and sign schedule, the Jacobi rotation schedule, the colour transform and
the flow IO helpers.  Also: the port imports without jax."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import vnlb_tpu.config as jcfg
from vnlb_tpu.ops import color as jcolor
from vnlb_tpu.ops import eigh as jeigh
from vnlb_tpu.ops import mask as jmask
from vnlb_tpu.ops import polyspec as jpoly
from vnlb_tpu.testing import data as jdata
from vnlb_tpu.utils import flow_io as jflow_io

import vnlb_tpu_torch.config as tcfg
from vnlb_tpu_torch.ops import color as tcolor
from vnlb_tpu_torch.ops import eigh as teigh
from vnlb_tpu_torch.ops import mask as tmask
from vnlb_tpu_torch.ops import polyspec as tpoly
from vnlb_tpu_torch.testing import data as tdata
from vnlb_tpu_torch.utils import flow_io as tflow_io

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


@pytest.mark.parametrize("t,h,w,seed,pan", [(5, 40, 52, 3, 2.0),
                                            (3, 64, 48, 0, -3.5)])
def test_synthetic_video_v2_matches(t, h, w, seed, pan):
    np.testing.assert_array_equal(
        tdata.synthetic_video_v2(t, h, w, seed=seed, pan=pan),
        jdata.synthetic_video_v2(t, h, w, seed=seed, pan=pan))


def test_agg_h_matches():
    """agg_h (read by agg_weight="exp") is JAX's, default and override."""
    assert tcfg.StageConfig.agg_h == jcfg.StageConfig.agg_h
    for kw in ({}, dict(agg_h=2.5), dict(agg_h=[1.0, 8.0])):
        got = tcfg.default_config(20.0, agg_weight="exp", **kw)
        want = jcfg.default_config(20.0, agg_weight="exp", **kw)
        assert [s.agg_h for s in got.stages] == \
            [s.agg_h for s in want.stages]


def test_flow_io_matches(tmp_path):
    """The .flo round trip of tests/test_api.py (test_flow_io_roundtrip),
    files written by one package read by the other, zero_flows and the
    colour wheel equal to JAX's."""
    rng = np.random.default_rng(0)
    flow = rng.normal(0, 3, (2, 12, 16)).astype(np.float32)
    tflow_io.write_flo(tmp_path / "t.flo", flow)
    jflow_io.write_flo(tmp_path / "j.flo", flow)
    assert (tmp_path / "t.flo").read_bytes() == \
        (tmp_path / "j.flo").read_bytes()
    back = tflow_io.read_flo(tmp_path / "j.flo")
    np.testing.assert_allclose(back, flow, atol=1e-6)
    np.testing.assert_array_equal(back, jflow_io.read_flo(tmp_path / "t.flo"))
    with pytest.raises(ValueError, match="magic"):
        (tmp_path / "bad.flo").write_bytes(b"\0" * 16)
        tflow_io.read_flo(tmp_path / "bad.flo")
    with pytest.raises(ValueError):
        tflow_io.write_flo(tmp_path / "x.flo", flow[0])

    f = rng.normal(0, 1, (3, 2, 8, 8)).astype(np.float32)
    b = rng.normal(0, 1, (3, 2, 8, 8)).astype(np.float32)
    fe, be = tflow_io.expand_flows(f, b)
    assert fe.shape[0] == 4 and be.shape[0] == 4
    np.testing.assert_array_equal(fe[-1], f[-1])
    np.testing.assert_array_equal(be[0], b[0])
    for got, want in zip(tflow_io.zero_flows((4, 3, 6, 7)),
                         jflow_io.zero_flows((4, 3, 6, 7))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)

    np.testing.assert_array_equal(tflow_io._make_colorwheel(),
                                  jflow_io._make_colorwheel())
    for mx in (None, 2.0):
        img = tflow_io.flow_to_image(flow, mx)
        assert img.shape == (12, 16, 3) and img.dtype == np.uint8
        np.testing.assert_array_equal(img, jflow_io.flow_to_image(flow, mx))


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


@pytest.mark.parametrize("ns_iters", [4, 8, 10, 14, 20])
def test_sign_schedule_matches(ns_iters):
    assert tpoly._AGGR == jpoly._AGGR
    assert tpoly._sign_schedule(ns_iters) == jpoly._sign_schedule(ns_iters)
    assert tpoly._sign_schedule(ns_iters, 2) == \
        jpoly._sign_schedule(ns_iters, 2)


@pytest.mark.parametrize("n", [2, 50, 60, 100])
def test_round_robin_schedule_matches(n):
    np.testing.assert_array_equal(teigh._round_robin_schedule(n),
                                  jeigh._round_robin_schedule(n))


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
            "vnlb_tpu_torch.ops.patch_gather, vnlb_tpu_torch.ops.search, "
            "vnlb_tpu_torch.utils.flow_io, vnlb_tpu_torch.utils.metrics, "
            "vnlb_tpu_torch.ops.poly_filter, vnlb_tpu_torch.ops.bayes, "
            "vnlb_tpu_torch.ops.eigh, vnlb_tpu_torch.ops.linalg, "
            "vnlb_tpu_torch.ops.spectral, vnlb_tpu_torch.ops.dense_dist, "
            "vnlb_tpu_torch.api, vnlb_tpu_torch.streaming, "
            "vnlb_tpu_torch.parallel.comm, "
            "vnlb_tpu_torch.parallel.launch, vnlb_tpu_torch.parallel.halo, "
            "vnlb_tpu_torch.parallel.tiled, vnlb_tpu_torch.parallel.tp, "
            "vnlb_tpu_torch.parallel.pipe, vnlb_tpu_torch.utils.video_io, "
            "vnlb_tpu_torch.compat, vnlb_tpu_torch.ops.flow, "
            "vnlb_tpu_torch.ops.agg, vnlb_tpu_torch.utils, "
            "vnlb_tpu_torch.utils.index, vnlb_tpu_torch.utils.timer, "
            "vnlb_tpu_torch.utils.logger, vnlb_tpu_torch.utils.flops, "
            "vnlb_tpu_torch.viz, vnlb_tpu_torch.viz.explore_gp, "
            "vnlb_tpu_torch.testing.npref, vnlb_tpu_torch.testing.oracle; "
            "from vnlb_tpu_torch.parallel.pipe import stage_meshes, "
            "pipelined_world; "
            "from vnlb_tpu_torch.utils import compute_ssim, coords2idx, "
            "Timer, trace, sync, Logger, vprint; "
            "assert callable(vnlb_tpu_torch.testing.data.load_golden); "
            "assert callable(vnlb_tpu_torch.viz.plot_patch_group); "
            "assert 'matplotlib' not in sys.modules; "
            "assert callable(vnlb_tpu_torch.denoise_streaming); "
            "assert callable(vnlb_tpu_torch.compat.denoise_compat); "
            "assert callable(vnlb_tpu_torch.ops.flow.estimate_flows); "
            "assert callable(vnlb_tpu_torch.utils.flow_io.read_flo); "
            "assert callable(vnlb_tpu_torch.testing.data.synthetic_video_v2); "
            "assert callable(vnlb_tpu_torch.denoise_mod); "
            "assert callable(vnlb_tpu_torch.proc_nn); "
            "assert callable(vnlb_tpu_torch.testing.oracle.lib); "
            "assert vnlb_tpu_torch.testing.oracle._lib is None; "
            "assert callable(vnlb_tpu_torch.testing.npref.bayes_denoise); "
            "assert 'PIL' not in sys.modules; "
            "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib', "
            "'vnlb_tpu.')) for m in sys.modules if sys.modules[m] is not None)")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_video_io_is_the_original():
    """utils/video_io.py is a copy of vnlb_tpu/utils/video_io.py, byte for
    byte (it imports neither jax nor anything of vnlb_tpu; PIL only inside
    its functions)."""
    port = os.path.join(REPO, "vnlb_tpu_torch", "utils", "video_io.py")
    orig = os.path.join(REPO, "vnlb_tpu", "utils", "video_io.py")
    with open(port, "rb") as a, open(orig, "rb") as b:
        assert a.read() == b.read()
