"""The check's controls come out as not correct: the program with its own
lower-precision scatter (``agg_bf16=True``: bf16 rows for f32) in place of
the program, and, on the card, the reference with TF32 on (TF32 for the
f32 products the configuration states) in the program's place.  Both at a
size a test run holds; the readings at the cells' own sizes come from
``perfbench/tools/calibrate.py`` on the card (PERF.md)."""

import time

import pytest
import torch

import vnlb_tpu_torch
from perfbench import reference
from perfbench.harness.loop import run_cell
from perfbench.tests.helpers import tiny

CELLS = ["iphone-480p-t5", "paper-480p-t5"]


class Program:
    """The program with ``denoise`` or ``default_config`` replaced."""

    def __init__(self, **attrs):
        self.__dict__.update(attrs)

    def __getattr__(self, name):
        return getattr(vnlb_tpu_torch, name)


def agg_bf16_program():
    def default_config(sigma, preset="iphone", **over):
        return vnlb_tpu_torch.default_config(sigma, preset=preset,
                                             **dict(over, agg_bf16=True))
    return Program(default_config=default_config)


def tf32_reference_program():
    def denoise(noisy, sigma, flows=None, cfg=None, device="cuda",
                kernels=None):
        t0 = time.perf_counter()
        rcfg = reference.default_config(sigma, preset=cfg.preset)
        deno, basic = reference.denoise(noisy, sigma, flows, rcfg, device,
                                        tf32=True)
        torch.cuda.synchronize(device)
        return deno, basic, time.perf_counter() - t0
    return Program(denoise=denoise)


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


@pytest.mark.parametrize("name", CELLS)
def test_agg_bf16_control_is_not_correct(name):
    got = run_cell(tiny(name), 2 ** 31 + 21, 0.01, False, "cpu",
                   time.perf_counter(), vt=agg_bf16_program())
    assert got["correct"] is False, got["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_tf32_control_is_not_correct_on_the_card(name):
    dev = card()
    cell = tiny(name, frames=5)
    cell = cell._replace(config=dict(cell.config, height=96, width=112))
    got = run_cell(cell, 2 ** 31 + 22, 0.01, False, dev, time.perf_counter(),
                   vt=tf32_reference_program())
    assert got["correct"] is False, got["checks"]
