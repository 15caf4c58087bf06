"""The port on the CPU against the C++ oracle through the port's own driver
(vnlb_tpu_torch/testing/oracle.py), with the inputs and tolerances of
tests/test_oracle.py: colour, lattice, the gather search (l2 and needle;
indices may differ only at ties), K4's plain gather, flat areas + the
Bayes filter (jacobi) and one pass.  Then: the port's copy of the C++
source is the original byte for byte; the port's driver and JAX's give
equal passes for equal configs; two processes that build the library at
once both load a working one; scripts/torch_compare_oracle.py runs with
jax blocked, and both passes of the port (agg_k=0, cols_bf16=False,
jacobi, l2) stay within chip_smoke's gates of the oracle on its clip."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import vnlb_tpu.config as jcfg
from vnlb_tpu.testing import oracle as jorc

import vnlb_tpu_torch as vt
from vnlb_tpu_torch.config import config_from_jax, default_config
from vnlb_tpu_torch.ops import color
from vnlb_tpu_torch.ops.bayes import bayes_denoise
from vnlb_tpu_torch.ops.flat import flat_areas
from vnlb_tpu_torch.ops.mask import lattice_mask
from vnlb_tpu_torch.ops.patch_gather import patch_gather_plain
from vnlb_tpu_torch.ops.search import exec_search
from vnlb_tpu_torch.pipeline import proc_nl
from vnlb_tpu_torch.testing import oracle as orc
from vnlb_tpu_torch.testing.data import add_noise, synthetic_video
from vnlb_tpu_torch.utils.metrics import compute_psnr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)

# the one-pass clip and config of tests/test_oracle.py::test_end_to_end_parity
# (reference-exact numerics: no agg_k thinning, f32 patch columns, exact
# eigh, l2 search)
E2E_OVERRIDES = dict(stype="l2", agg_k=0, cols_bf16=False,
                     eig_method="jacobi")


@pytest.fixture(scope="module")
def built():
    orc.lib()
    return True


def assert_topk_match(py_vals, py_inds, or_vals, or_inds, tol=1e-5):
    """Index-exact comparison with tie tolerance (tests/test_oracle.py)."""
    py_vals, py_inds = np.asarray(py_vals), np.asarray(py_inds)
    neq = np.where(py_inds != or_inds)
    if neq[0].size:
        # mismatched entries must carry (near-)equal distances
        dv = np.abs(py_vals[neq] - or_vals[neq])
        assert dv.max() < tol, (neq, dv.max())
    np.testing.assert_allclose(py_vals, or_vals, rtol=1e-4, atol=1e-5)


def _rows(p):
    b, k, pt, c, ps, _ = p.shape
    return torch.from_numpy(p).permute(0, 1, 3, 2, 4, 5).reshape(b, k, c, -1)


def rel_err(got, want):
    return np.abs(got - want).mean() / (np.abs(want).mean() + 1e-8)


def test_color_parity(built):
    rng = np.random.default_rng(0)
    v = rng.uniform(0, 255, (2, 3, 12, 12)).astype(np.float32)
    np.testing.assert_allclose(color.rgb2yuv(torch.from_numpy(v)).numpy(),
                               orc.oracle_rgb2yuv(v), atol=1e-3)
    np.testing.assert_allclose(color.yuv2rgb(torch.from_numpy(v)).numpy(),
                               orc.oracle_yuv2rgb(v), atol=1e-3)


def test_lattice_parity(built):
    cfg = default_config(20.0, preset="iphone").stage(0)
    for shape in [(3, 3, 32, 32), (4, 3, 41, 37)]:
        np.testing.assert_array_equal(lattice_mask(shape, cfg),
                                      orc.oracle_lattice(shape, cfg))


def test_search_parity_l2(built):
    rng = np.random.default_rng(1)
    video = rng.uniform(0, 255, (4, 3, 40, 44)).astype(np.float32)
    fflow = rng.uniform(-2, 2, (4, 2, 40, 44)).astype(np.float32)
    bflow = rng.uniform(-2, 2, (4, 2, 40, 44)).astype(np.float32)
    cfg = default_config(20.0, preset="iphone").stage(1).replace(
        nwt_b=2, nwt_f=2, npatches=12)
    sites = np.array([[1, 4, 6], [2, 20, 30], [0, 0, 0], [2, 33, 37]],
                     np.int32)
    pv, pi = exec_search(torch.from_numpy(video), torch.from_numpy(sites),
                         torch.from_numpy(fflow), torch.from_numpy(bflow),
                         cfg)
    ov, oi = orc.oracle_search(video, sites, fflow, bflow, cfg)
    assert_topk_match(pv, pi, ov, oi)


def test_search_parity_needle(built):
    rng = np.random.default_rng(2)
    video = rng.uniform(0, 255, (3, 3, 64, 64)).astype(np.float32)
    zf = np.zeros((3, 2, 64, 64), np.float32)
    cfg = default_config(20.0, preset="iphone").stage(0).replace(
        nwt_b=1, nwt_f=1, npatches=10, stype="needle")
    sites = np.array([[1, 10, 12], [0, 40, 40]], np.int32)
    zt = torch.from_numpy(zf)
    pv, pi = exec_search(torch.from_numpy(video), torch.from_numpy(sites),
                         zt, zt, cfg)
    ov, oi = orc.oracle_search(video, sites, zf, zf, cfg)
    assert_topk_match(pv, pi, ov, oi)


def test_gather_parity(built):
    """K4's plain version (c-major rows) against the oracle's (B, K, pt,
    C, ps, ps) patches."""
    rng = np.random.default_rng(3)
    video = rng.uniform(0, 255, (3, 3, 24, 24)).astype(np.float32)
    chw = 3 * 24 * 24
    inds = (rng.integers(0, 2, (4, 5)) * chw
            + rng.integers(0, 18, (4, 5)) * 24
            + rng.integers(0, 18, (4, 5))).astype(np.int32)
    got, = patch_gather_plain([torch.from_numpy(video)],
                              torch.from_numpy(inds), 7, 2, False)
    want = orc.oracle_fill_patches(video, inds, 2, 7)
    np.testing.assert_allclose(got.numpy(), _rows(want).numpy(), atol=1e-6)


def test_bayes_flat_parity(built):
    rng = np.random.default_rng(4)
    sigma = 10.0
    base = rng.normal(0, 30, (3, 1, 2, 3, 5, 5))
    pnoisy = (base + rng.normal(0, sigma, (3, 16, 2, 3, 5, 5))).astype(np.float32)
    pbasic = (base + rng.normal(0, 1, (3, 16, 2, 3, 5, 5))).astype(np.float32)
    # exact-eigh pin (the presets default to the poly filter)
    cfg = default_config(sigma).stage(1).replace(ps=5, rank=10,
                                                 eig_method="jacobi")

    oflags = orc.oracle_flat(pnoisy, cfg.gamma, cfg.sigma2)
    tflags = flat_areas(_rows(pnoisy), cfg.gamma, cfg.sigma2)
    np.testing.assert_array_equal(tflags.numpy(), oflags)

    got, _ = bayes_denoise(_rows(pnoisy), _rows(pbasic), tflags, cfg)
    want = orc.oracle_bayes(pnoisy, pbasic, oflags.astype(np.uint8), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-3, atol=5e-2)


@pytest.fixture(scope="module")
def one_pass(built):
    """(noisy, zero flow, port config, the oracle's pass) of
    tests/test_oracle.py::test_end_to_end_parity."""
    clean = synthetic_video(3, 32, 32, seed=5)
    noisy = add_noise(clean, 20.0, seed=6)
    zf = np.zeros((3, 2, 32, 32), np.float32)
    cfg = default_config(20.0, preset="iphone").stage(0).replace(
        **E2E_OVERRIDES)
    return noisy, zf, cfg, orc.oracle_proc_nl(noisy, None, zf, zf, cfg)


def test_end_to_end_parity(one_pass):
    """One pass of the port's pipeline against the composed oracle."""
    noisy, zf, cfg, want = one_pass
    zt = torch.from_numpy(zf)
    got = proc_nl(torch.from_numpy(noisy), None, None, zt, zt, cfg).numpy()
    err = np.abs(got - want)
    rel = rel_err(got, want)
    assert rel < 2e-3, f"mean relative error {rel}"
    assert err.max() < 10.0, f"max abs error {err.max()}"


def test_oracle_source_is_the_original():
    port = os.path.join(REPO, "vnlb_tpu_torch", "oracle", "vnlb_oracle.cpp")
    orig = os.path.join(REPO, "vnlb_tpu", "oracle", "vnlb_oracle.cpp")
    with open(port, "rb") as a, open(orig, "rb") as b:
        assert a.read() == b.read()


def test_drivers_agree(one_pass):
    """JAX's driver with JAX's config of the same overrides gives the port
    driver's pass, bit for bit."""
    noisy, zf, cfg, want = one_pass
    j = jcfg.default_config(20.0, preset="iphone").stage(0).replace(
        **E2E_OVERRIDES)
    assert config_from_jax(j) == cfg
    got = jorc.oracle_proc_nl(noisy, None, zf, zf, j)
    assert np.array_equal(got, want)


_BUILD_AND_RUN = """
import sys
from pathlib import Path
import numpy as np
sys.modules['jax'] = None
sys.modules['vnlb_tpu'] = None
from vnlb_tpu_torch.testing import oracle, npref
oracle.BUILD_DIR = Path(sys.argv[1])
v = np.random.default_rng(0).uniform(0, 255, (2, 3, 8, 8)).astype(np.float32)
np.testing.assert_allclose(oracle.oracle_rgb2yuv(v), npref.rgb2yuv(v),
                           atol=1e-3)
print(oracle.library_path().name)
"""


def test_concurrent_builds_load(tmp_path):
    """Two processes that find no library build it at once (each under a
    name of its own, renamed into place); both load a working one."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_RUN,
                               str(tmp_path)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    names = {out.strip() for out, _ in outs}
    assert names == {orc.library_path().name}
    assert sorted(f.name for f in tmp_path.iterdir()) == sorted(names)


@pytest.fixture(scope="module")
def compare_run(tmp_path_factory):
    """scripts/torch_compare_oracle.py's main at --frames 3 --size 32 on
    the CPU in a process with jax and vnlb_tpu blocked: (its stdout, the
    clip and the oracle's passes).  ``--eig xla`` (exact eigh in torch)
    keeps the port's side of the run short; the oracle's side does not
    depend on it."""
    out_npz = tmp_path_factory.mktemp("compare") / "run.npz"
    path = os.path.join(REPO, "scripts", "torch_compare_oracle.py")
    code = ("import sys, runpy; import numpy as np; "
            "sys.modules['jax'] = None; sys.modules['vnlb_tpu'] = None; "
            f"main = runpy.run_path({path!r})['main']; "
            "res = main(['--frames', '3', '--size', '32', '--eig', 'xla', "
            "'--device', 'cpu']); "
            f"np.savez({str(out_npz)!r}, **{{k: res[k] for k in ('clean', "
            "'noisy', 'o_basic', 'o_deno')}); "
            "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib', "
            "'vnlb_tpu.')) for m in sys.modules if sys.modules[m] is not None)")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout, dict(np.load(out_npz))


def test_compare_script_runs_without_jax(compare_run):
    out, run = compare_run
    assert run["noisy"].shape == run["o_deno"].shape == (3, 3, 32, 32)
    table = dict(re.findall(r"^\| ([^|]+?) \| ([^|]*?) \|", out, re.M))
    assert float(table["basic rel. error"]) < 2e-2, out
    assert float(table["deno rel. error"]) < 2e-2, out
    assert re.search(r"\| PSNR port \(basic/deno\) \| [\d.]+ \| [\d.]+ \|",
                     out), out
    o_psnr = [compute_psnr(run[k], run["clean"]) for k in ("o_basic",
                                                            "o_deno")]
    assert table["PSNR oracle (basic/deno)"] == f"{o_psnr[0]:.4f}", out
    assert min(o_psnr) > compute_psnr(run["noisy"], run["clean"]) + 3.0


def test_two_passes_match_oracle(compare_run):
    """Both passes of the port under the oracle's own semantics (all K
    aggregated, f32 columns, exact eigh, l2) against ``oracle_denoise`` on
    the script's clip: mean relative error < 2e-3 in each pass and
    |dPSNR| <= 0.01 dB (chip_smoke's gates for this run on the card).  The
    oracle reads none of the overrides, so the script's oracle run is this
    config's."""
    _, run = compare_run
    cfg = default_config(20.0, preset="iphone", stype=["l2", "l2"],
                         agg_k=0, cols_bf16=False, eig_method="jacobi")
    deno, basic, _ = vt.denoise(run["noisy"], 20.0, cfg=cfg, device="cpu")
    for got, want in ((basic.numpy(), run["o_basic"]),
                      (deno.numpy(), run["o_deno"])):
        assert rel_err(got, want) < 2e-3
        assert abs(compute_psnr(got, run["clean"])
                   - compute_psnr(want, run["clean"])) <= 0.01
