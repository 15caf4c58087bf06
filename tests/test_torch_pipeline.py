"""End-to-end parity of the PyTorch port against the JAX package on the CPU:
each pass and the two-pass ``denoise`` on a (5, 96, 112) clip at sigma=20
with the bench config; the API default (no cfg: step 3, sliding borders)
on a (4, 64, 72) clip with zero flow and with the clip's own drift flow;
the search overrides ``dense_rows="full"`` and ``topk`` stream / approx
on that clip; determinism; flow forms (the filter modes are held to JAX
by tests/test_torch_bayes_modes.py and tests/test_torch_presets.py, the
aggregation modes by tests/test_torch_agg_modes.py)."""

import numpy as np
import pytest
import torch

import vnlb_tpu
from vnlb_tpu.pipeline import proc_nl as j_proc_nl

import vnlb_tpu_torch as vt
from vnlb_tpu_torch.config import config_from_jax
from vnlb_tpu_torch.testing.data import add_noise, drift_flows, synthetic_video
from vnlb_tpu_torch.utils.flow_io import expand_flows
from vnlb_tpu_torch.utils.metrics import compute_psnr

torch.set_num_threads(2)

BENCH = dict(preset="iphone", eig_method="poly", step_s=6,
             border_mode="mask", topk="exact")


@pytest.fixture(scope="module")
def clip():
    clean = synthetic_video(5, 96, 112, seed=0)
    return clean, add_noise(clean, 20.0, seed=1)


@pytest.fixture(scope="module")
def jax_run(clip):
    clean, noisy = clip
    cfg = vnlb_tpu.default_config(20.0, **BENCH)
    deno, basic, _ = vnlb_tpu.denoise(noisy, 20.0, cfg=cfg)
    return cfg, np.array(basic), np.array(deno)


@pytest.fixture(scope="module")
def port_run(clip):
    clean, noisy = clip
    cfg = vt.default_config(20.0, **BENCH)
    deno, basic, sec = vt.denoise(noisy, 20.0, cfg=cfg, device="cpu")
    return deno.numpy(), basic.numpy(), sec


def _close(got, want, clean):
    dpsnr = abs(compute_psnr(got, clean) - compute_psnr(want, clean))
    assert dpsnr < 0.02, dpsnr
    mad = np.abs(got - want).mean()
    assert mad < 0.25, mad


def test_first_pass_matches_jax(clip, jax_run):
    clean, noisy = clip
    jc, jbasic, _ = jax_run
    got = vt.proc_nl(torch.from_numpy(noisy), None, None, None, None,
                     config_from_jax(jc.stage(0))).numpy()
    _close(got, jbasic, clean)


def test_second_pass_matches_jax(clip, jax_run):
    clean, noisy = clip
    jc, jbasic, jdeno = jax_run
    zf = np.zeros((5, 2, 96, 112), np.float32)
    want = np.asarray(j_proc_nl(noisy, jbasic, None, zf, zf, jc.stage(1),
                                zero_flow=True))
    np.testing.assert_array_equal(want, jdeno)
    got = vt.proc_nl(torch.from_numpy(noisy), torch.from_numpy(jbasic), None,
                     None, None, config_from_jax(jc.stage(1))).numpy()
    _close(got, want, clean)


def test_denoise_matches_jax(clip, jax_run, port_run):
    clean, noisy = clip
    _, jbasic, jdeno = jax_run
    deno, basic, sec = port_run
    assert deno.shape == basic.shape == noisy.shape
    assert np.isfinite(deno).all() and sec > 0
    _close(basic, jbasic, clean)
    _close(deno, jdeno, clean)
    assert compute_psnr(deno, clean) >= compute_psnr(noisy, clean) + 6.0


def test_denoise_repeat_is_bitwise(clip, port_run):
    clean, noisy = clip
    deno, basic, _ = vt.denoise(noisy, 20.0, device="cpu",
                                cfg=vt.default_config(20.0, **BENCH))
    np.testing.assert_array_equal(basic.numpy(), port_run[1])
    np.testing.assert_array_equal(deno.numpy(), port_run[0])


def test_streaming_mesh_raises(clip):
    """denoise_streaming(mesh=...) runs each window through proc_nl_halo
    (tests/test_torch_parallel.py runs it in a 2-rank world); 8 strips of
    12 rows are below the halo of 14, so it refuses before any
    communication."""
    from vnlb_tpu_torch.parallel.comm import Mesh

    _, noisy = clip
    mesh = Mesh(None, 0, 8, torch.device("cpu"))
    with pytest.raises(ValueError, match="strip"):
        vt.denoise_streaming(noisy, 20.0, chunk=3, mesh=mesh, device="cpu")


@pytest.fixture(scope="module")
def small_clip():
    clean = synthetic_video(4, 64, 72, seed=0)
    return clean, add_noise(clean, 20.0, seed=1), drift_flows(4, 64, 72)


@pytest.fixture(scope="module")
def api_runs(small_clip):
    """(port, JAX) (basic, deno) pairs of ``denoise(noisy, 20.0)`` with no
    cfg, for zero flow and for the (T-1)-frame drift flow pair."""
    clean, noisy, drift = small_clip
    runs = {}
    for name, flows in (("zero", None), ("drift", drift)):
        deno, basic, _ = vt.denoise(noisy, 20.0, flows=flows, device="cpu")
        jdeno, jbasic, _ = vnlb_tpu.denoise(noisy, 20.0, flows=flows)
        runs[name] = ((basic.numpy(), deno.numpy()),
                      (np.array(jbasic), np.array(jdeno)))
    return runs


@pytest.mark.parametrize("flow", ["zero", "drift"])
def test_api_default_matches_jax(small_clip, api_runs, flow):
    clean, noisy, _ = small_clip
    (basic, deno), (jbasic, jdeno) = api_runs[flow]
    assert deno.shape == noisy.shape and np.isfinite(deno).all()
    _close(basic, jbasic, clean)
    _close(deno, jdeno, clean)
    assert compute_psnr(deno, clean) >= compute_psnr(noisy, clean) + 6.0


@pytest.mark.parametrize("override", [
    dict(dense_rows="full"), dict(topk="stream"), dict(topk="approx")])
def test_search_override_matches_jax(small_clip, api_runs, override):
    """The all-rows search (K3) and the stream / approx top-K run on the
    CPU.  The top-K modes give the exact top-K's bits, as in JAX (its
    stream mode is pinned bitwise to exact by tests/test_search_dense.py,
    and approx_max_k is exact off the TPU), so they are held to the exact
    runs of both packages; the all-rows search to JAX's own all-rows run."""
    clean, noisy, _ = small_clip
    deno, basic, _ = vt.denoise(noisy, 20.0, device="cpu",
                                cfg=vt.default_config(20.0, **override))
    basic, deno = basic.numpy(), deno.numpy()
    (pbasic, pdeno), want = api_runs["zero"]
    if "topk" in override:
        np.testing.assert_array_equal(basic, pbasic)
        np.testing.assert_array_equal(deno, pdeno)
    else:
        jdeno, jbasic, _ = vnlb_tpu.denoise(
            noisy, 20.0, cfg=vnlb_tpu.default_config(20.0, **override))
        want = (np.asarray(jbasic), np.asarray(jdeno))
    _close(basic, want[0], clean)
    _close(deno, want[1], clean)


def test_flow_pair_expands(small_clip, api_runs):
    """A (T-1)-frame flow pair runs, and equals the run with the flows
    edge-replicated to T frames (as a dict)."""
    _, noisy, (ff, bf) = small_clip
    fx, bx = expand_flows(ff, bf)
    deno, basic, _ = vt.denoise(noisy, 20.0, device="cpu",
                                flows={"fflow": fx, "bflow": bx})
    np.testing.assert_array_equal(basic.numpy(), api_runs["drift"][0][0])
    np.testing.assert_array_equal(deno.numpy(), api_runs["drift"][0][1])


def test_repeat_with_flow_is_bitwise(small_clip, api_runs):
    _, noisy, drift = small_clip
    deno, basic, _ = vt.denoise(noisy, 20.0, flows=drift, device="cpu")
    np.testing.assert_array_equal(basic.numpy(), api_runs["drift"][0][0])
    np.testing.assert_array_equal(deno.numpy(), api_runs["drift"][0][1])


def test_mask_with_flow_takes_gather_route(small_clip):
    """With a nonzero flow, ``border_mode="mask"`` plans every site for the
    gather search, as JAX does, and the pass matches JAX's."""
    clean, noisy, drift = small_clip
    fx, bx = expand_flows(*drift)
    jc = vnlb_tpu.default_config(20.0, border_mode="mask").stage(0)
    cfg = config_from_jax(jc)
    sites, n_dense = vt.pipeline.plan_sites(noisy.shape, cfg, False)
    assert n_dense == 0 and len(sites) > 0
    want = np.asarray(j_proc_nl(noisy, None, None, fx, bx, jc))
    got = vt.proc_nl(torch.from_numpy(noisy), None, None, fx, bx, cfg)
    _close(got.numpy(), want, clean)


def test_site_chunks_do_not_change_output(clip, monkeypatch):
    """The pass runs over chunks of sites; per-site work is independent and
    the scatter keeps the global order, so chunking changes nothing but the
    last bits of the plain filter (CPU batched matmuls are not invariant
    to the batch size; on the card the kernel path is bitwise invariant,
    tests/test_torch_cuda.py)."""
    _, noisy = clip
    cfg = vt.default_config(20.0, **BENCH).stage(1)
    small = torch.from_numpy(noisy[:, :, :48, :64].copy())
    whole = vt.proc_nl(small, small, None, None, None, cfg)
    monkeypatch.setattr(vt.pipeline, "SITE_CHUNK", 97)
    chunked = vt.proc_nl(small, small, None, None, None, cfg)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=1e-3)
