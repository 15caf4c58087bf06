"""A run without a card fails, a checkout without the program fails, and
the check catches a broken timed path: the run's correctness verdict with
faults planted under the window (on the CPU, at a small size)."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from perfbench.harness import spec
from perfbench.harness.loop import run_cell
from perfbench.tests.helpers import copy_bench, tiny
from perfbench.tools.calibrate import frame_off, half_sites

ARGS = ["--workload", "iphone-480p-t5", "--seed", "3000000001",
        "--seconds", "1", "--trace", "0"]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "perfbench/run.py", *ARGS],
                         capture_output=True, text=True, timeout=300,
                         cwd=spec.ROOT, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


def test_checkout_without_program_fails(tmp_path):
    root = copy_bench(tmp_path)
    child = ("import sys, time; sys.path.insert(0, '.');"
             "from perfbench.harness import spec, loop;"
             "from perfbench.tests.helpers import tiny;"
             "c = spec.cell('iphone-480p-t5', root='.');"
             "loop.run_cell(c, 1, 0.01, False, 'cpu', time.perf_counter(),"
             " root='.')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", child], capture_output=True,
                         text=True, timeout=300, cwd=root, env=env)
    assert out.returncode != 0
    assert "vnlb_tpu_torch" in out.stderr


def run_tiny(name, hook=None, seed=2 ** 31 + 11):
    return run_cell(tiny(name), seed, 0.01, False, "cpu",
                    time.perf_counter(), call_hook=hook)




CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    got = run_tiny(name)
    assert got["correct"] is True, got["checks"]
    assert list(got)[-1] == "checks"
    json.dumps(got)


@pytest.mark.parametrize("fault", ["identity", "half", "frame"])
def test_faults_are_not_correct(fault, monkeypatch):
    import vnlb_tpu_torch as vt

    name = "iphone-480p-t5"
    if fault == "identity":
        real = vt.denoise

        def unchanged(noisy, sigma, **kw):
            deno, basic, sec = real(noisy, sigma, **kw)
            return noisy.clone(), noisy.clone(), sec
        monkeypatch.setattr(vt, "denoise", unchanged)
        got = run_tiny(name)
    elif fault == "half":
        with half_sites(vt):
            got = run_tiny(name)
    else:
        got = run_tiny(name, hook=frame_off)
    assert got["correct"] is False, got["checks"]
