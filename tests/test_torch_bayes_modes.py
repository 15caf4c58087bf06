"""Every branch of the port's ``bayes_denoise`` dispatch against the JAX
package on the CPU: the eigen modes (xla, jacobi, rational), the poly
modes (econ, two-factor on the ``poly_impl="pallas"`` and ``poly_econ=False``
routes, fused), ``couple_channels``, the ``poly_impl="pallas"`` and
``couple_channels`` modes without ``poly_bf16``, preset ``default`` with
``couple_channels``, with ``poly_impl="pallas"`` (with and without
``poly_bf16``), without ``poly_bf16`` and with ``poly_econ=False,
poly_bf16=False``, and ``deno="ave"``; plus the batched
Jacobi eigenvalues and the Cholesky inverse.  Filtered patches are
compared, not eigenvectors (signs and degenerate subspaces differ)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import vnlb_tpu.config as jcfg
from vnlb_tpu.ops.bayes import ave_denoise as j_ave
from vnlb_tpu.ops.bayes import bayes_denoise as j_bayes
from vnlb_tpu.ops.eigh import jacobi_eigh as j_jacobi
from vnlb_tpu.ops.linalg import chol_inverse as j_chol_inverse

from vnlb_tpu_torch.config import config_from_jax
from vnlb_tpu_torch.ops.bayes import ave_denoise, bayes_denoise
from vnlb_tpu_torch.ops.eigh import jacobi_eigh
from vnlb_tpu_torch.ops.linalg import chol_inverse

torch.set_num_threads(2)

# (port overrides, JAX overrides or None for the same, f32 rms bound):
# the JAX package runs poly_impl="pallas" through a Pallas call the CPU
# cannot lower outside interpret mode, so that case is held against the
# plain reference of the same function (poly_filter: poly_econ and
# poly_fused off).  Bounds: measured rms 2e-6 - 8e-6 for the exact modes,
# 4e-4 - 7e-4 for the joint econ groups, 2e-3 - 3e-3 for the two-factor
# filter's bf16 sign gate in the second pass (2.0e-3 / 5.2e-3 on its joint
# couple_channels groups, stage 0 / 1).  Without poly_bf16 (the "_f32"
# modes, no bf16 gate) the measured rms is 1.3e-6 / 1.7e-6 (poly_pallas),
# 2.3e-6 / 5.0e-6 (couple) and 1.3e-6 / 2.3e-6 (poly_pallas_couple), stage
# 0 / 1; preset default's joint econ groups 3.4e-4 / 7.3e-4.  Preset
# default's (100, 98) first pass: poly_impl="pallas" 5.5e-4 / 3.1e-3 (bf16
# gate), without poly_bf16 1.3e-6 / 1.7e-6; poly_bf16 off (econ) 1.7e-6 /
# 2.9e-6; poly_econ and poly_bf16 off 1.3e-6 / 3.1e-6.
MODES = {
    "xla": (dict(eig_method="xla"), None, 1e-4),
    "jacobi": (dict(eig_method="jacobi"), None, 1e-4),
    "rational": (dict(eig_method="rational"), None, 1e-4),
    "poly_econ": (dict(), None, 5e-3),
    "poly_pallas": (dict(poly_impl="pallas"),
                    dict(poly_econ=False, poly_fused=False), 2e-2),
    "poly_pallas_couple": (dict(poly_impl="pallas", couple_channels=True),
                           dict(couple_channels=True, poly_econ=False,
                                poly_fused=False), 2e-2),
    "poly_econ_off": (dict(poly_econ=False), None, 2e-2),
    "couple_channels": (dict(couple_channels=True), None, 5e-3),
    "couple_xla": (dict(couple_channels=True, eig_method="xla"), None, 1e-4),
    "poly_pallas_f32": (dict(poly_impl="pallas", poly_bf16=False),
                        dict(poly_econ=False, poly_fused=False,
                             poly_bf16=False), 1e-4),
    "couple_f32": (dict(couple_channels=True, poly_bf16=False), None, 1e-4),
    "poly_pallas_couple_f32": (
        dict(poly_impl="pallas", couple_channels=True, poly_bf16=False),
        dict(couple_channels=True, poly_econ=False, poly_fused=False,
             poly_bf16=False), 1e-4),
    "default_couple": (dict(preset="default", couple_channels=True), None,
                       5e-3),
    "default_pallas": (dict(preset="default", poly_impl="pallas"),
                       dict(preset="default", poly_econ=False,
                            poly_fused=False), 2e-2),
    "default_pallas_f32": (dict(preset="default", poly_impl="pallas",
                                poly_bf16=False),
                           dict(preset="default", poly_econ=False,
                                poly_fused=False, poly_bf16=False), 1e-4),
    "default_f32": (dict(preset="default", poly_bf16=False), None, 1e-4),
    "default_econ_off_f32": (dict(preset="default", poly_econ=False,
                                  poly_bf16=False), None, 1e-4),
}


def _patches(stage, jc, seed):
    rng = np.random.default_rng(seed)
    b, k, c, p = 4, jc.npatches, 3, jc.pdim
    clean = rng.uniform(40, 200, (b, 1, c, p)).astype(np.float32)
    struct = (rng.normal(0, 15, (b, 1, c, p))
              * rng.normal(0, 1, (b, k, 1, 1))).astype(np.float32)
    pn = clean + struct + rng.normal(0, 20, (b, k, c, p)).astype(np.float32)
    pb = clean + struct + rng.normal(0, 5, (b, k, c, p)).astype(np.float32)
    flags = np.array([True, False, True, False])
    return pn, pb, flags


@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("mode", list(MODES))
def test_bayes_mode_matches_jax(mode, stage):
    kw, jkw, bound = MODES[mode]
    jc = jcfg.default_config(20.0, **(kw if jkw is None else jkw)).stage(
        stage)
    tc = config_from_jax(jcfg.default_config(20.0, **kw).stage(stage))
    pn, pb, flags = _patches(stage, jc, 10 + stage)
    if stage == 1:
        want, wvar = j_bayes(jnp.asarray(pn), jnp.asarray(pb),
                             jnp.asarray(flags), jc)
        got, gvar = bayes_denoise(torch.from_numpy(pn), torch.from_numpy(pb),
                                  torch.from_numpy(flags), tc)
    else:
        want, wvar = j_bayes(jnp.asarray(pn), None, None, jc)
        got, gvar = bayes_denoise(torch.from_numpy(pn), None, None, tc)
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape == (4, tc.npatches, tc.pt, 3, tc.ps,
                                       tc.ps)
    np.testing.assert_allclose(gvar.numpy(), np.asarray(wvar), rtol=1e-4)
    # errors relative to the filtered signal around the group means
    scale = np.abs(want - want.mean(axis=1, keepdims=True)).mean()
    rms = np.sqrt(np.mean((got - want) ** 2)) / scale
    assert rms < bound, rms


def test_ave_denoise_matches_jax():
    """``deno="ave"``: the raw patches, c-major rows -> public layout as
    vnlb_tpu/pipeline.py:210-220 does."""
    jc = jcfg.default_config(20.0, preset="default").stage(1)
    rng = np.random.default_rng(3)
    b, k, c = 5, jc.npatches, 3
    x = rng.uniform(0, 255, (b, k, c, jc.pdim)).astype(np.float32)
    want = np.asarray(j_ave(jnp.asarray(x)))
    want = np.transpose(want.reshape(b, k, c, jc.pt, jc.ps * jc.ps),
                        (0, 1, 3, 2, 4)).reshape(b, k, jc.pt, c, jc.ps,
                                                 jc.ps)
    got = ave_denoise(torch.from_numpy(x), config_from_jax(jc)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [49, 60])     # odd n pads to 50
def test_jacobi_eigh_matches_jax(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(6, 80, n)).astype(np.float32)
    x[:, :, :5] *= 10.0
    mats = np.einsum("gkp,gkq->gpq", x, x) / 80.0
    wl, _ = j_jacobi(jnp.asarray(mats), sweeps=8)
    gl, gv = jacobi_eigh(torch.from_numpy(mats), sweeps=8)
    wl = np.asarray(wl)
    np.testing.assert_allclose(gl.numpy(), wl, rtol=1e-4,
                               atol=1e-5 * wl.max())
    assert (np.diff(gl.numpy(), axis=1) <= 0).all()
    # the eigenvectors diagonalize the input
    rec = gv @ torch.diag_embed(gl) @ gv.transpose(1, 2)
    np.testing.assert_allclose(rec.numpy(), mats, atol=1e-4 * wl.max())


def test_chol_inverse_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(5, 70, 40)).astype(np.float32)
    mats = np.einsum("gkp,gkq->gpq", x, x) / 70.0 + 0.1 * np.eye(40)
    mats = mats.astype(np.float32)
    want = np.asarray(j_chol_inverse(jnp.asarray(mats)))
    got = chol_inverse(torch.from_numpy(mats)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got @ mats, np.broadcast_to(np.eye(40),
                                                           mats.shape),
                               atol=1e-3)
