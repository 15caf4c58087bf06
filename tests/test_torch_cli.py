"""The port's command-line scripts (``scripts/torch_*.py``) on the CPU, each
a subprocess with jax and ``vnlb_tpu`` blocked (``sys.modules[...] =
None``), ``--device cpu``: the quickstart and the one-sequence script on
``davis_64x64`` (deno >= noisy + 6 dB, as the verify notes expect), and the
set sweep over a data root of two tiny frame sequences (a summary row
each, then a rerun that skips both from the result cache)."""

import json
import os
import re
import subprocess
import sys

import numpy as np

from vnlb_tpu_torch.testing.data import synthetic_video

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, *args, cwd, env=None):
    path = os.path.join(REPO, "scripts", script)
    code = ("import sys, runpy; sys.modules['jax'] = None; "
            "sys.modules['vnlb_tpu'] = None; "
            f"sys.argv = {[path, *args]!r}; "
            f"runpy.run_path({path!r}, run_name='__main__')")
    env = dict(os.environ, OMP_NUM_THREADS="2", **(env or {}))
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_torch_example(tmp_path):
    out = _run("torch_example.py", "--dataset", "davis_64x64", "--device",
               "cpu", "--save", str(tmp_path / "saved"), cwd=tmp_path,
               env=dict(VNLB_TPU_DATA=str(tmp_path / "none")))
    psnr = {k: float(v) for k, v in
            re.findall(r"psnr\s+(\w+): ([\d.]+) dB", out)}
    assert psnr["deno"] >= psnr["noisy"] + 6.0, out
    assert psnr["basic"] >= psnr["noisy"] + 6.0, out
    ssim = float(re.search(r"ssim\s+deno: ([\d.]+)", out).group(1))
    assert 0.8 < ssim < 1.0
    assert len(os.listdir(tmp_path / "saved")) == 10


def test_torch_process_video_sequence(tmp_path):
    env = dict(VNLB_TPU_DATA=str(tmp_path / "none"),
               VNLB_TPU_CACHE=str(tmp_path / "cache"))
    out = _run("torch_process_video_sequence.py", "davis_64x64", "--device",
               "cpu", "--nframes", "3", cwd=tmp_path, env=env)
    res = json.loads(out[out.index("{"):])
    assert res["video"] == "davis_64x64" and res["sigma"] == 20.0
    assert res["psnr_deno"] >= res["psnr_noisy"] + 6.0, res
    cached = (tmp_path / "cache" / "results" / "vnlb" / "custom" /
              "davis_64x64" / "20")
    assert np.load(cached / "deno.npy").shape == (3, 3, 64, 64)
    assert json.loads((cached / "metrics.json").read_text()) == res


def test_torch_process_video_set(tmp_path):
    from PIL import Image

    for i, name in enumerate(("clip_a", "clip_b")):
        d = tmp_path / "data" / "tiny" / name
        d.mkdir(parents=True)
        for t, f in enumerate(synthetic_video(3, 64, 64, seed=10 + i)):
            img = np.clip(f, 0, 255).astype(np.uint8).transpose(1, 2, 0)
            Image.fromarray(img).save(d / f"{t:03d}.png")
    env = dict(VNLB_TPU_DATA=str(tmp_path / "data"),
               VNLB_TPU_CACHE=str(tmp_path / "cache"))
    args = ("--vid-set", "tiny", "--device", "cpu", "--retries", "0")
    out = _run("torch_process_video_set.py", *args, cwd=tmp_path, env=env)
    rows = json.loads((tmp_path / "output" / "tiny_s20_summary.json")
                      .read_text())
    assert [r["video"] for r in rows] == ["clip_a", "clip_b"], out
    for r in rows:
        assert r["psnr_deno"] >= r["psnr_noisy"] + 6.0, r
    assert "| clip_b |" in out
    again = _run("torch_process_video_set.py", *args, cwd=tmp_path, env=env)
    assert again.count("cached, skipping") == 2, again
