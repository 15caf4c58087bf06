#!/usr/bin/env python3
"""The JAX package's two-pass ``denoise`` on the CPU at 5x480x854, sigma
20, with the drift flow of ``vnlb_tpu_torch.testing.data.drift_flows``
and with zero flow: the reference numbers for the port's 480p runs on the
card (chip_smoke.py's ``e2e_api_drift`` and ``e2e_api_zero``).

    JAX_PLATFORMS=cpu python scripts/jax_drift_480p.py

Prints one line per flow: PSNR of noisy, basic and deno, and the seconds
taken (about 5 minutes each on 8 CPU cores, ~10 GB of memory).
"""

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import vnlb_tpu  # noqa: E402
from vnlb_tpu.testing.data import add_noise, synthetic_video  # noqa: E402
from vnlb_tpu.utils.metrics import compute_psnr  # noqa: E402
from vnlb_tpu_torch.testing.data import drift_flows  # noqa: E402

T, H, W, SIGMA = 5, 480, 854, 20.0


def main():
    clean = synthetic_video(T, H, W, seed=0)
    noisy = add_noise(clean, SIGMA, seed=1)
    for name, flows in (("drift", drift_flows(T, H, W)), ("zero", None)):
        t0 = time.perf_counter()
        deno, basic, _ = vnlb_tpu.denoise(noisy, SIGMA, flows=flows)
        deno, basic = np.asarray(deno), np.asarray(basic)
        print(f"flow={name} psnr_noisy={compute_psnr(noisy, clean):.6f} "
              f"psnr_basic={compute_psnr(basic, clean):.6f} "
              f"psnr_deno={compute_psnr(deno, clean):.6f} "
              f"seconds={time.perf_counter() - t0:.1f}", flush=True)


if __name__ == "__main__":
    main()
