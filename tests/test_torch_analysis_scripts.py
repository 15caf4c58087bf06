"""The port's analysis scripts against the JAX package's, on the CPU:
``scripts/torch_deno_v_basic.py`` against ``scripts/deno_v_basic.py`` and
``exps/torch_interp_square.py`` against ``exps/interp_square.py``, each on
``davis_64x64`` (the synthetic 5x64x64 stand-in) in a subprocess of its
own.  The port's subprocess runs with jax and ``vnlb_tpu`` blocked
(``sys.modules[...] = None``) and ``--device cpu``; each side has its own
``VNLB_TPU_CACHE`` and ``VNLB_TPU_DATA``.  The printed PSNRs agree within
0.02 dB (overall, per frame and region, each delta, each surface point)
and the surface's best blend is the same.  Under one shared cache the
port keeps its memo apart from the JAX script's: it writes its own and
never prints the JAX memo's bytes."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_DB = 0.02
ARGS = ("--dataset", "davis_64x64", "--sigma", "20")


def _run(rel_path, args, env, port):
    """Run a script of the repo in a subprocess; its stdout."""
    path = os.path.join(REPO, rel_path)
    if port:
        pre = ("sys.modules['jax'] = None; sys.modules['vnlb_tpu'] = None; ")
        args = (*args, "--device", "cpu")
    else:
        # the JAX script on the CPU (its own directory importable, as when
        # run by path)
        pre = (f"sys.path.insert(0, {os.path.dirname(path)!r}); "
               "import jax; jax.config.update('jax_platforms', 'cpu'); ")
    code = (f"import runpy, sys; {pre}sys.argv = {[path, *args]!r}; "
            f"runpy.run_path({path!r}, run_name='__main__')")
    env = dict(os.environ, OMP_NUM_THREADS="2", JAX_PLATFORMS="cpu",
               VNLB_TPU_NO_CACHE="1", **env)
    env.pop("XLA_FLAGS", None)
    if port:
        env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def _dirs(tmp, side):
    return dict(VNLB_TPU_CACHE=str(tmp / side / "cache"),
                VNLB_TPU_DATA=str(tmp / side / "data"))


def _deno_v_basic(out):
    """({"basic", "deno"}, {(frame, region): (basic, deno, delta)})."""
    total = re.search(r"basic: ([\d.]+) dB\s+deno: ([\d.]+) dB", out)
    regions = {(int(f), r): (float(b), float(d), float(dl)) for f, r, b, d, dl
               in re.findall(r"frame (\d+) (\w+): basic ([\d.]+)\s+deno "
                             r"([\d.]+)\s+delta ([+-][\d.]+) dB", out)}
    return dict(basic=float(total.group(1)),
                deno=float(total.group(2))), regions


@pytest.fixture(scope="module")
def deno_v_basic_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("deno_v_basic")
    return tuple(_deno_v_basic(_run(script, ARGS, _dirs(tmp, side), port))
                 for script, side, port in (
                     ("scripts/deno_v_basic.py", "jax", False),
                     ("scripts/torch_deno_v_basic.py", "port", True)))


def test_deno_v_basic_psnr_matches_jax(deno_v_basic_runs):
    (jax_total, _), (port_total, _) = deno_v_basic_runs
    for k in ("basic", "deno"):
        assert abs(port_total[k] - jax_total[k]) <= TOL_DB, (port_total,
                                                              jax_total)
    assert port_total["deno"] > port_total["basic"] - 1.0


def test_deno_v_basic_regions_match_jax(deno_v_basic_runs):
    (_, jax_regions), (_, port_regions) = deno_v_basic_runs
    assert set(port_regions) == {(t, r) for t in range(5)
                                 for r in ("edge", "flat")}
    assert set(port_regions) == set(jax_regions)
    for key, got in port_regions.items():
        want = jax_regions[key]
        # basic, deno and their delta, each as printed
        assert max(abs(a - b) for a, b in zip(got, want)) <= TOL_DB, (
            key, got, want)


@pytest.fixture(scope="module")
def interp_runs(tmp_path_factory):
    """The JAX script and the port's, each under its own cache, then the
    port's again under the JAX run's cache with the JAX memo replaced by
    a marker: (jax surface, port surface, port text in the shared cache,
    that cache's root, the marker)."""
    tmp = tmp_path_factory.mktemp("interp_square")
    jax_dirs, port_dirs = _dirs(tmp, "jax"), _dirs(tmp, "port")
    jax_out = _run("exps/interp_square.py", ARGS, jax_dirs, False)
    port_out = _run("exps/torch_interp_square.py", ARGS, port_dirs, True)
    shared = jax_dirs["VNLB_TPU_CACHE"]
    (jax_memo,) = (tmp / "jax" / "cache" / "exps" / "interp_square").iterdir()
    marker = json.dumps({"surface": [], "best": {"written by": "the JAX "
                                                 "script"}})
    jax_memo.write_text(marker)
    shared_out = _run("exps/torch_interp_square.py", ARGS, jax_dirs, True)
    return (json.loads(jax_out), json.loads(port_out), shared_out, shared,
            marker)


def test_interp_square_surface_matches_jax(interp_runs):
    jax_s, port_s = interp_runs[:2]
    key = [(r["alpha"], r["beta"]) for r in jax_s["surface"]]
    assert [(r["alpha"], r["beta"]) for r in port_s["surface"]] == key
    assert len(key) == 15
    for got, want in zip(port_s["surface"], jax_s["surface"]):
        assert abs(got["psnr"] - want["psnr"]) <= TOL_DB, (got, want)
    assert ((port_s["best"]["alpha"], port_s["best"]["beta"])
            == (jax_s["best"]["alpha"], jax_s["best"]["beta"]))


def test_interp_square_memo_apart_from_jax(interp_runs):
    jax_s, _, shared_out, shared, marker = interp_runs
    assert "written by" not in shared_out
    got = json.loads(shared_out)
    # the port's own memo under the shared cache holds what it printed
    (memo,) = (Path(shared) / "exps" / "torch_interp_square").iterdir()
    assert json.loads(memo.read_text()) == got
    (jax_memo,) = (Path(shared) / "exps" / "interp_square").iterdir()
    assert jax_memo.read_text() == marker
    # the vnlb output came from the shared result layout (the JAX run's)
    for r, want in zip(got["surface"], jax_s["surface"]):
        assert abs(r["psnr"] - want["psnr"]) <= 1e-9, (r, want)
    assert (Path(shared) / "results" / "vnlb" / "davis_64x64" / "exp"
            / "20" / "deno.npy").exists()
