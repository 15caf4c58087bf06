"""The port's utility surface against the JAX package's on the CPU:

* ``compute_ssim``, the flat index codec and the work model
  (``utils/flops.py``) equal JAX's exactly;
* ``load_dataset`` (every registered name without a data root, and a set
  of frames on disk) and ``load_golden`` (the ``.npy`` and tif layouts
  with a ``.flo`` pair) return what JAX's return, bit for bit (the flows
  as (T, 2, H, W) stacks, where JAX's are transposed to (T, W, 2, H));
* ``Timer``, ``trace`` (unset: the region just runs; set: a
  ``torch.profiler`` trace is written), ``sync``, ``vprint``, ``Logger``
  and ``plot_patch_group`` each do their one job.
"""

import os

import numpy as np
import pytest
import torch

import vnlb_tpu.config as jcfg
from vnlb_tpu.testing import data as jdata
from vnlb_tpu.utils import flops as jflops
from vnlb_tpu.utils import index as jindex
from vnlb_tpu.utils import metrics as jmetrics
from vnlb_tpu.utils.flow_io import write_flo

import vnlb_tpu_torch.config as tcfg
import vnlb_tpu_torch.utils as tutils
from vnlb_tpu_torch.testing import data as tdata
from vnlb_tpu_torch.utils import flops as tflops
from vnlb_tpu_torch.utils import logger as tlogger
from vnlb_tpu_torch.viz import plot_patch_group


@pytest.mark.parametrize("shape", [(2, 3, 20, 24), (1, 1, 11, 11),
                                   (3, 17, 19)])
@pytest.mark.parametrize("imax", [255.0, 1.0])
def test_compute_ssim_equals_jax(shape, imax):
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    clean = rng.uniform(0, imax, shape).astype(np.float32)
    deno = (clean + rng.normal(0, 0.05 * imax, shape)).astype(np.float32)
    got = tutils.compute_ssim(deno, clean, imax)
    assert got == jmetrics.compute_ssim(deno, clean, imax)
    assert 0 < got < 1
    assert tutils.compute_ssim(clean, clean, imax) == pytest.approx(1.0)


@pytest.mark.parametrize("shape", [(5, 3, 64, 72), (12, 1, 480, 854)])
def test_index_codec_equals_jax(shape):
    _, c, h, w = shape
    rng = np.random.default_rng(7)
    idx = rng.integers(0, shape[0] * c * h * w, 500).astype(np.int64)
    want = jindex.idx2coords(idx, c, h, w)
    want_full = jindex.idx2coords_full(idx, c, h, w)
    for x in (idx, torch.from_numpy(idx)):
        got = tutils.idx2coords(x, c, h, w)
        got_full = tutils.idx2coords_full(x, c, h, w)
        for a, b in zip(got + got_full, want + want_full):
            np.testing.assert_array_equal(np.asarray(a), b)
        t, y, xx = got
        back = tutils.coords2idx(t, y, xx, c, h, w)
        np.testing.assert_array_equal(
            np.asarray(back), jindex.coords2idx(*want, c, h, w))
    # a corner's flat index drops the colour plane: t*C*H*W + y*W + x
    t, y, xx = want
    np.testing.assert_array_equal(jindex.coords2idx(t, y, xx, c, h, w),
                                  idx - want_full[1] * h * w)


@pytest.mark.parametrize("preset", tcfg.PRESETS)
def test_flops_equal_jax(preset):
    shape = (5, 3, 96, 112)
    for over in ({}, dict(eig_method="xla"), dict(poly_gram=False),
                 dict(couple_channels=True)):
        jc = jcfg.default_config(20.0, preset=preset, **over)
        tc = tcfg.default_config(20.0, preset=preset, **over)
        for step, sites in ((0, 4096), (1, 12345)):
            got = tflops.pass_flops(shape, tc.stage(step), sites)
            assert got == jflops.pass_flops(shape, jc.stage(step), sites)
            assert all(v > 0 for v in got.values())
        assert tflops.two_pass_flops(shape, tc, 4096, 12345) == \
            jflops.two_pass_flops(shape, jc, 4096, 12345)
    assert not any(n.startswith("V5E") for n in dir(tflops))
    assert (tflops.PEAK_F32, tflops.PEAK_BF16, tflops.HBM_BPS) == \
        (67e12, 989e12, 3.35e12)


@pytest.mark.parametrize("name", sorted(tdata.DATASETS))
def test_load_dataset_synthetic_equals_jax(name, tmp_path, monkeypatch):
    monkeypatch.setenv("VNLB_TPU_DATA", str(tmp_path))
    assert tdata.DATASETS == jdata.DATASETS
    assert tdata.data_root() == jdata.data_root() == tmp_path
    got = tdata.load_dataset(name, sigma=20.0)
    want = jdata.load_dataset(name, sigma=20.0)
    assert got.keys() == want.keys() and got["std"] == want["std"]
    for k in ("clean", "noisy", "fflow", "bflow"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["clean"].shape == (tdata.DATASETS[name][0], 3) \
        + tdata.DATASETS[name][1:]


def test_load_dataset_davis_is_the_smoke_clip(tmp_path, monkeypatch):
    """``load_dataset("davis")`` is chip_smoke.py's main clip: synthetic
    seed 0, noise seed 1."""
    monkeypatch.setenv("VNLB_TPU_DATA", str(tmp_path))
    data = tdata.load_dataset("davis")
    clean = tdata.synthetic_video(5, 480, 854, seed=0)
    np.testing.assert_array_equal(data["clean"], clean)
    np.testing.assert_array_equal(data["noisy"],
                                  tdata.add_noise(clean, 20.0, seed=1))
    with pytest.raises(KeyError, match="registered"):
        tdata.load_dataset("nope")


def _write_frames(root, frames, pattern):
    from PIL import Image

    root.mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(frames):
        img = np.clip(f, 0, 255).astype(np.uint8).transpose(1, 2, 0)
        Image.fromarray(img).save(root / (pattern % i))


def test_load_dataset_on_disk_equals_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("VNLB_TPU_DATA", str(tmp_path))
    _write_frames(tmp_path / "mine", tdata.synthetic_video(3, 24, 28),
                  "%03d.png")
    (tmp_path / "mine" / "sigma.txt").write_text("15")
    got, want = tdata.load_dataset("mine"), jdata.load_dataset("mine")
    assert got["std"] == want["std"] == 15.0
    for k in ("clean", "noisy", "fflow", "bflow"):
        np.testing.assert_array_equal(got[k], want[k])


def _golden_dir(root, layout):
    rng = np.random.default_rng(3)
    frames = {k: rng.uniform(0, 255, (2, 3, 12, 16)).round().astype(
        np.float32) for k in ("deno", "basic", "noisy")}
    if layout == "npy":
        root.mkdir(parents=True)
        for k, v in frames.items():
            np.save(root / f"{k}.npy", v)
    else:
        for k, pat in (("deno", "deno_%03d.tif"), ("basic", "bsic_%03d.tif"),
                       ("noisy", "%03d.tif")):
            _write_frames(root, frames[k], pat)
    (root / "sigma.txt").write_text("20")
    for d in ("f", "b"):
        write_flo(root / f"tvl1_000_{d}.flo",
                  rng.normal(0, 2, (2, 12, 16)).astype(np.float32))


@pytest.mark.parametrize("layout", ["npy", "tif"])
def test_load_golden_equals_jax(layout, tmp_path, monkeypatch):
    monkeypatch.setenv("VNLB_TPU_DATA", str(tmp_path))
    assert tdata.load_golden("gold") is None
    assert jdata.load_golden("gold") is None
    _golden_dir(tmp_path / "gold", layout)
    got, want = tdata.load_golden("gold"), jdata.load_golden("gold")
    assert sorted(got) == sorted(want) == ["basic", "bflow", "deno", "fflow",
                                           "noisy", "sigma"]
    assert got["sigma"] == want["sigma"] == 20.0
    # JAX's flows are (T, W, 2, H): read_flo's (2, H, W) transposed again
    for k in ("fflow", "bflow"):
        want[k] = want[k].transpose(0, 2, 3, 1)
    for k in ("deno", "basic", "noisy", "fflow", "bflow"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert got["fflow"].shape == (1, 2, 12, 16)


def test_timer():
    t = tutils.Timer()
    with pytest.raises(RuntimeError):
        t.toc()
    with t:
        sum(range(1000))
    assert t.elapsed > 0
    assert t.tic().toc() >= 0


def test_trace_unset_runs_the_region(tmp_path, monkeypatch):
    monkeypatch.delenv("VNLB_TPU_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    ran = []
    with tutils.trace("region"):
        ran.append(1)
    assert ran == [1] and not os.listdir(tmp_path)


def test_trace_set_writes_a_profile(tmp_path, monkeypatch):
    monkeypatch.setenv("VNLB_TPU_PROFILE", str(tmp_path))
    with tutils.trace("region"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path)
    assert files and all(f.endswith(".json") for f in files)
    assert '"region"' in (tmp_path / files[0]).read_text()


def test_sync_returns_the_tree():
    tree = {"a": [torch.ones(2), (np.zeros(1), 3)], "b": torch.zeros(1)}
    assert tutils.sync(tree) is tree


def test_vprint(capsys, monkeypatch):
    monkeypatch.setattr(tlogger, "VERBOSE", False)
    tutils.vprint("hidden")
    monkeypatch.setattr(tlogger, "VERBOSE", True)
    tutils.vprint("shown", 1)
    assert capsys.readouterr().out == "shown 1\n"


def test_logger_tees(tmp_path, capsys):
    log = tutils.Logger(str(tmp_path / "run.log"))
    try:
        log.write("line\n")
        log.flush()
    finally:
        log.close()
    assert capsys.readouterr().out == "line\n"
    assert (tmp_path / "run.log").read_text() == "line\n"


def test_plot_patch_group(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(0)
    group = rng.normal(size=(40, 2, 3, 5, 5))
    path = plot_patch_group(group, group * 0.5, path=tmp_path / "g.png")
    assert os.path.getsize(path) > 0
