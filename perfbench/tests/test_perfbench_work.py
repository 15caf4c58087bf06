"""The frozen work models give chip_smoke.py's numbers (the bounds of
PERF.md's kernel table) at the kernel table's shapes."""

import pytest
import torch

import chip_smoke as cs
import vnlb_tpu_torch as vt
from perfbench.work import models

API = vt.default_config(20.0)
PAPER = vt.default_config(20.0, preset="default")
F32 = vt.default_config(20.0, poly_bf16=False)
PAPER_F32 = vt.default_config(20.0, preset="default", poly_bf16=False)

# (config stage, g, k, p, the table's bound in ms)
K2_ROWS = [
    (API.stage(0), 12288, 100, 49, 0.216),
    (API.stage(1), 12288, 60, 98, 0.259),
    (PAPER.stage(0), 12288, 100, 98, 0.431),
    (F32.stage(0), 12288, 100, 49, 0.216),
    (PAPER_F32.stage(0), 12288, 100, 98, 0.711),
    (F32.stage(1), 12288, 60, 98, 0.279),
]
K5_ROWS = [
    (API.stage(1), 12288, 60, 98, 0.595),
    (API.stage(0), 12288, 100, 49, 0.216),
    (F32.stage(1), 12288, 60, 98, 1.879),
    (PAPER.stage(0), 12288, 100, 98, 0.753),
    (PAPER_F32.stage(0), 12288, 100, 98, 1.845),
]


def test_peaks():
    assert (models.PEAK_F32, models.PEAK_BF16, models.PEAK_TF32,
            models.HBM_BPS) == (cs.PEAK_F32, cs.PEAK_BF16, cs.PEAK_TF32,
                                cs.HBM_BPS)


@pytest.mark.parametrize("row", K2_ROWS, ids=lambda r: f"{r[2]}x{r[3]}")
def test_econ_work(row):
    scfg, g, k, p, table_ms = row
    got = models.econ_work(g, k, p, scfg)
    assert got == cs.econ_work(g, k, p, scfg)
    assert models.bound(*got) == cs.bound(*got)
    assert models.bound(*got)[0] == pytest.approx(table_ms, abs=5e-4)


@pytest.mark.parametrize("row", K5_ROWS, ids=lambda r: f"{r[2]}x{r[3]}")
def test_poly_work(row):
    scfg, g, k, p, table_ms = row
    got = models.poly_work(g, k, p, scfg)
    assert got == cs.poly_work(g, k, p, scfg)
    assert models.bound(*got)[0] == pytest.approx(table_ms, abs=5e-4)


@pytest.mark.parametrize("case", [
    # (stage, level height, sites, dt planes, window starts, the table's
    # bound in ms)
    (API.stage(1), 480, 4096, 7, False, 0.085),
    (API.stage(0), 480, 4096, 9, False, 0.018),
    (API.stage(0), 240, 4096, 9, False, None),
    (API.stage(1), 480, 4096, 7, True, 0.085),
    (API.stage(1), 480, 46046, 7, False, 0.955),
], ids=lambda c: f"s{c[0].step}-h{c[1]}-n{c[2]}-starts{int(c[4])}")
def test_k1_work(case):
    scfg, h, n, planes, starts, table_ms = case
    c = scfg.dist_chnls
    vid = torch.zeros((5, c, h, 854 * h // 480))
    sites = torch.zeros((n, 3), dtype=torch.int32)
    want = cs.k1_work(sites, vid, scfg, starts=2 * starts, planes=planes)
    got = models.k1_work(n, sites.numel() * 4, vid.numel(), c, scfg.pt,
                         scfg.ps, scfg.w_s, starts=2 * starts, planes=planes)
    assert got == want
    if table_ms is not None:
        assert got[0] == pytest.approx(table_ms, abs=5e-4)


def test_scalar_logic_matches_polyspec():
    from vnlb_tpu_torch.ops.polyspec import _ps_split, _sign_schedule
    for deg in range(4, 40):
        assert models.ps_split(deg) == _ps_split(deg)
    for ns in range(1, 20):
        assert models.sign_schedule(ns) == _sign_schedule(ns)
