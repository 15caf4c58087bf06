"""Configuration of the PyTorch port: the same frozen dataclasses as the JAX
package (vnlb_tpu/config.py), copied field for field so the port carries
no import of jax.  ``config_from_jax`` rebuilds a port config from a
``vnlb_tpu`` config object; the tests pin the two equal for every preset.

Field meanings are documented on the JAX original; the port runs every
value the JAX package runs.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

PRESETS = ("default", "exp", "sss", "sss_v2", "iphone")


@dataclasses.dataclass(frozen=True)
class StageConfig:
    """All parameters of ONE denoising pass."""

    step: int
    sigma: float
    sigma_basic: float
    ps: int = 7
    pt: int = 2
    npatches: int = 100
    agg_k: int = 0
    agg_weight: str = "uniform"
    agg_h: float = 4.0
    w_s: int = 27
    nwt_f: int = 6
    nwt_b: int = 6
    rank: int = 39
    thresh: float = 2.7
    gamma: float = 0.95
    beta: float = 1.0
    tau: float = 0.0
    offset: float = 0.0
    flat_areas: bool = False
    couple_channels: bool = False
    aggre_boost: bool = True
    nkeep: int = -1
    step_s: int = 3
    only_frame: int = -1
    mod_sel: str = "clipped"
    stype: str = "l2"
    srch_img: str = "noisy"
    cpatches: str = "noisy"
    deno: str = "bayes"
    dist_chnls: int = 1
    bsize: int = 256
    needle_scales: int = 3
    topk: str = "exact"
    border_mode: str = "slide"
    dense_impl: str = "auto"
    dense_rows: str = "auto"
    cols_bf16: bool = True
    eig_method: str = "jacobi"
    eig_sweeps: int = 8
    gate_power: int = 1
    gate_scale: float = 1.0
    ns_iters: int = 14
    poly_deg: int = 12
    poly_bf16: bool = True
    poly_econ: bool = True
    poly_fused: bool = True
    poly_deg_fused: int = 28
    poly_gram: bool = True
    poly_pack2: bool = True
    search_bf16: bool = True
    agg_bf16: bool = False
    poly_impl: str = "xla"

    @property
    def sigma2(self) -> float:
        return self.sigma ** 2

    @property
    def sigmab2(self) -> float:
        return self.beta * self.sigma_basic ** 2

    @property
    def n_dt(self) -> int:
        return self.nwt_b + self.nwt_f + 1

    @property
    def n_cands(self) -> int:
        return self.n_dt * self.w_s * self.w_s

    @property
    def pdim(self) -> int:
        return self.pt * self.ps * self.ps

    def replace(self, **kw) -> "StageConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class VnlbConfig:
    """Two-stage configuration."""

    sigma: float
    stages: Tuple[StageConfig, ...]
    preset: str = "default"
    verbose: bool = False

    def stage(self, i: int) -> StageConfig:
        return self.stages[i]


def default_config(sigma: float, preset: str = "iphone", verbose: bool = False,
                   **overrides) -> VnlbConfig:
    """The two-stage config of vnlb_tpu.config.default_config, value for
    value.  ``overrides`` apply to both stages when scalar, per stage when a
    2-list/2-tuple."""
    if preset not in PRESETS:
        raise ValueError(f"unknown preset [{preset}]; options: {PRESETS}")

    offset0 = 2.0 * (sigma / 255.0) ** 2
    base = dict(sigma=float(sigma))
    # fused-series degree 16*sqrt(20/sigma), a multiple of 4 in [8, 32]
    deg_f = int(min(32, max(8, -(-16.0 * (20.0 / max(sigma, 1.0)) ** 0.5
                                 // 4) * 4)))

    s0 = dict(base, step=0, sigma_basic=float(sigma), npatches=100, gamma=0.95,
              thresh=2.7, tau=0.0, flat_areas=False, offset=offset0,
              srch_img="noisy", cpatches="noisy", dist_chnls=1, agg_k=32,
              eig_method="poly", ns_iters=10, poly_deg=8, poly_deg_fused=deg_f,
              cols_bf16=True)
    s1 = dict(base, step=1, sigma_basic=0.0, npatches=60, gamma=0.2,
              thresh=0.7, tau=0.0, flat_areas=True, offset=0.0,
              srch_img="basic", cpatches="basic", dist_chnls=3,
              eig_method="poly", ns_iters=10, poly_deg=8, poly_deg_fused=deg_f,
              agg_k=32, cols_bf16=True)

    if preset in ("sss", "sss_v2", "iphone"):
        for s in (s0, s1):
            s.update(w_s=15, nwt_f=10, nwt_b=10)
    if preset == "sss_v2":
        s0.update(pt=1)
    if preset == "iphone":
        s0.update(pt=1, stype="needle")

    for k, v in overrides.items():
        vals = v if isinstance(v, (list, tuple)) else (v, v)
        s0[k], s1[k] = vals[0], vals[1]

    stages = (StageConfig(**s0), StageConfig(**s1))
    return VnlbConfig(sigma=float(sigma), stages=stages, preset=preset,
                      verbose=verbose)


def _stage_from(obj) -> StageConfig:
    names = {f.name for f in dataclasses.fields(StageConfig)}
    theirs = {f.name for f in dataclasses.fields(obj)}
    if names != theirs:
        raise ValueError(f"StageConfig fields differ: "
                         f"{sorted(names ^ theirs)}")
    return StageConfig(**{n: getattr(obj, n) for n in names})


def config_from_jax(obj):
    """Rebuild a port config from a ``vnlb_tpu`` StageConfig or VnlbConfig
    (any dataclass with the same fields), without importing jax."""
    if not dataclasses.is_dataclass(obj):
        raise TypeError(f"expected a config dataclass, got {type(obj)}")
    if hasattr(obj, "stages"):
        return VnlbConfig(sigma=obj.sigma,
                          stages=tuple(_stage_from(s) for s in obj.stages),
                          preset=obj.preset, verbose=obj.verbose)
    return _stage_from(obj)
