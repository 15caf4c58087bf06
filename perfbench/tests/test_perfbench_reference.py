"""The plain reference is the port's plain path, frozen: bitwise equal to
``vnlb_tpu_torch.denoise(..., kernels=PLAIN)`` on the CPU, with the same
configurations; and the frozen traffic generator is the port's."""

import dataclasses

import numpy as np
import pytest
import torch

import vnlb_tpu_torch as vt
from vnlb_tpu_torch.testing import data
from perfbench import reference
from perfbench.harness import spec
from perfbench.traffic import generator

CONTENT = spec.plugin("traffic/content", "synthetic_video")
DRIFT = spec.plugin("traffic/flow", "drift")
MOTION = {"motion": 1.5}


@pytest.mark.parametrize("preset", ["iphone", "default", "exp", "sss",
                                    "sss_v2"])
def test_configs_equal(preset):
    for over in ({}, {"agg_bf16": True, "poly_bf16": False}):
        a = vt.default_config(20.0, preset=preset, **over)
        b = reference.default_config(20.0, preset=preset, **over)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("preset,flow", [("iphone", False),
                                         ("default", False),
                                         ("iphone", True)])
def test_reference_is_the_plain_path(preset, flow):
    torch.manual_seed(0)
    rng = np.random.default_rng(3)
    clean = CONTENT.make(MOTION, 3, 40, 48, rng)
    noisy = generator.add_noise(clean, 20.0, rng)
    flows = DRIFT.make(MOTION, clean) if flow else None
    d, b, _ = vt.denoise(noisy, 20.0, flows=flows,
                         cfg=vt.default_config(20.0, preset=preset),
                         device="cpu", kernels=vt.PLAIN)
    rd, rb = reference.denoise(noisy, 20.0, flows,
                               reference.default_config(20.0, preset=preset),
                               "cpu")
    assert torch.equal(d, rd) and torch.equal(b, rb)


def test_generator_is_the_ports():
    for seed in (0, 7):
        got = CONTENT.make(MOTION, 4, 30, 36, np.random.default_rng(seed))
        assert np.array_equal(got, data.synthetic_video(4, 30, 36,
                                                        seed=seed))
        noisy = generator.add_noise(got, 20.0, np.random.default_rng(seed))
        assert np.array_equal(noisy, data.add_noise(got, 20.0, seed=seed))
    for a, b in zip(DRIFT.make(MOTION, np.zeros((4, 3, 30, 36))),
                    data.drift_flows(4, 30, 36)):
        assert np.array_equal(a, b)
