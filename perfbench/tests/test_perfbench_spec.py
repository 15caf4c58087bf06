"""BENCHMARK.json and the files it names: every entry loads by name, every
name and unit keeps to the contract, and a new cell is new files."""

import json
import re
import time

import pytest

from perfbench.harness import spec
from perfbench.harness.loop import run_cell
from perfbench.tests.helpers import TINY, copy_bench, write_json

BENCH = spec.benchmark()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
ONE_LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    spec.check_name(conf["name"], "config")
    assert ONE_LINE.match(conf["source"]) and ONE_LINE.match(conf["why"])
    assert conf["file"].startswith("perfbench/configs/")
    data = spec.load_json(spec.ROOT / conf["file"])
    for key in ("preset", "sigma", "height", "width", "overrides", "source",
                "assumed"):
        assert key in data
    assert all(spec.NAME_RE.match(k) for k in conf["reduced"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_loads(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    assert ONE_LINE.match(cell["why"])
    c = spec.cell(cell["name"])
    assert c.traffic["frames"] >= 2
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    assert c.limits.get("limits"), "every cell has check limits"


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    spec.check_name(metric["name"], "metric")
    spec.check_unit(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in spec.SOURCES
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert ONE_LINE.match(metric["layer"])
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert callable(spec.metric_reader(metric["name"]))


def test_every_config_used_and_names_unique():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for key in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("bad", ["", "a b", "a/b", "-x", "x" * 65, "é"])
def test_bad_names_refused(bad):
    with pytest.raises(ValueError):
        spec.check_name(bad, "name")


@pytest.mark.parametrize("bad", ["", "tokens per s", "x" * 17, "µs"])
def test_bad_units_refused(bad):
    with pytest.raises(ValueError):
        spec.check_unit(bad)


def test_unknown_cell_refused():
    with pytest.raises(ValueError):
        spec.cell("no-such-cell")


def test_new_cell_is_new_files(tmp_path):
    """A configuration, a traffic mix and a limits file added beside the
    others, and entries in BENCHMARK.json, make a cell that runs, with no
    file of the harness edited."""
    root = copy_bench(tmp_path)
    write_json(root / "perfbench/configs/tiny-iphone.json",
               dict(spec.load_json(spec.ROOT / "perfbench/configs/"
                                   "vnlb-iphone-480p.json"), **TINY))
    write_json(root / "perfbench/traffic/t3-tiny.json",
               {"frames": 3, "content": "synthetic_video", "motion": 1.5,
                "flow": "zero", "entry": "denoise", "pool": 1,
                "check_calls": 1})
    write_json(root / "perfbench/workloads/tiny-cell.json",
               {"limits": {"deno_rms": 0.0, "basic_rms": 0.0}})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-iphone", "source": "test",
                             "file": "perfbench/configs/tiny-iphone.json",
                             "reduced": ["height", "width"], "why": "test"})
    bench["workloads"].append({"name": "tiny-cell", "config": "tiny-iphone",
                               "traffic": "t3-tiny", "chips": 1,
                               "why": "test"})
    write_json(root / "BENCHMARK.json", bench)
    c = spec.cell("tiny-cell", root=root)
    assert c.config["height"] == TINY["height"]
    got = run_cell(c, 2 ** 31 + 3, 0.01, False, "cpu", time.perf_counter(),
                   root=root)
    assert got["correct"] is True
    assert {"fps", "setup_s", "peak_mem_gib"} <= set(got["metrics"])


def tiny_cell(root, traffic: dict, name="tiny-cell"):
    """A cell of the iphone configuration at a tiny size under ``traffic``,
    added to the copy at ``root`` as files and entries."""
    write_json(root / "perfbench/configs/tiny-iphone.json",
               dict(spec.load_json(spec.ROOT / "perfbench/configs/"
                                   "vnlb-iphone-480p.json"), **TINY))
    write_json(root / "perfbench/traffic/t3-new.json", traffic)
    write_json(root / f"perfbench/workloads/{name}.json",
               {"limits": {"deno_rms": 0.0, "basic_rms": 0.0}})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-iphone", "source": "test",
                             "file": "perfbench/configs/tiny-iphone.json",
                             "reduced": ["height", "width"], "why": "test"})
    bench["workloads"].append({"name": name, "config": "tiny-iphone",
                               "traffic": "t3-new", "chips": 1,
                               "why": "test"})
    return bench


def test_new_content_flow_and_entry_are_new_files(tmp_path):
    """A content, a flow and an entry that the harness has never seen, each
    a module of its own, make a cell that runs and is checked."""
    root = copy_bench(tmp_path)
    traffic = root / "perfbench/traffic"
    (traffic / "content/ramp.py").write_text(
        "import numpy as np\n"
        "def make(mix, t, h, w, rng):\n"
        "    x = np.linspace(0, mix['top'], w, dtype=np.float32)\n"
        "    clip = np.broadcast_to(x, (t, 3, h, w)).copy()\n"
        "    return clip + rng.uniform(0, 1, clip.shape).astype(np.float32)\n")
    (traffic / "flow/still.py").write_text(
        "import numpy as np\n"
        "def make(mix, clean):\n"
        "    f = np.zeros((clean.shape[0] - 1, 2) + clean.shape[2:],"
        " np.float32)\n"
        "    return f, f.copy()\n")
    (traffic / "entry/denoise_twice.py").write_text(
        "def program(vt, noisy, clip, sigma, cfg, device, kernels):\n"
        "    vt.denoise(noisy, sigma, flows=clip.flows, cfg=cfg,"
        " device=device, kernels=kernels)\n"
        "    return vt.denoise(noisy, sigma, flows=clip.flows, cfg=cfg,"
        " device=device, kernels=kernels)[:2]\n"
        "def reference(ref, clip, sigma, cfg, device, **kw):\n"
        "    return ref.denoise(clip.noisy, sigma, clip.flows, cfg, device,"
        " **kw)\n")
    bench = tiny_cell(root, {"frames": 3, "content": "ramp", "top": 200.0,
                             "flow": "still", "entry": "denoise_twice",
                             "pool": 1, "check_calls": 1})
    write_json(root / "BENCHMARK.json", bench)
    c = spec.cell("tiny-cell", root=root)
    got = run_cell(c, 2 ** 31 + 4, 0.01, False, "cpu", time.perf_counter(),
                   root=root)
    assert got["correct"] is True
    assert got["checks"]["deno_rms"]["value"] == 0.0


def test_new_metric_and_range_are_new_files(tmp_path):
    """A per-layer metric that reads a kernel no metric read before and a
    range around an entry no range wrapped before, each a file of its own,
    are reported by a traced run."""
    root = copy_bench(tmp_path)
    write_json(root / "perfbench/ranges/ops.flat.json",
               {"module": "vnlb_tpu_torch.ops.flat",
                "attribute": "flat_areas", "depth": 3})
    (root / "perfbench/metrics/gather.logged_calls.py").write_text(
        "def read(rec):\n"
        "    calls = rec.kernel_calls.get('kernel.patch_gather', [])\n"
        "    videos = [v for c in calls for v in c['args'][0]]\n"
        "    if not videos or any(len(v.shape) != 4 for v in videos):\n"
        "        return None\n"
        "    return float(len(calls))\n")
    (root / "perfbench/metrics/flat.ran.py").write_text(
        "def read(rec):\n"
        "    return 1.0 if 'ops.flat' in rec.in_range else None\n")
    bench = tiny_cell(root, {"frames": 3, "content": "synthetic_video",
                             "motion": 1.5, "flow": "zero",
                             "entry": "denoise", "pool": 1,
                             "check_calls": 1})
    for name in ("gather.logged_calls", "flat.ran"):
        bench["per_layer"].append({
            "name": name, "unit": "calls", "better": "lower",
            "source": "device_trace", "layer": "test", "moves": "fps",
            "workloads": ["tiny-cell"]})
    write_json(root / "BENCHMARK.json", bench)
    c = spec.cell("tiny-cell", root=root)
    got = run_cell(c, 2 ** 31 + 5, 0.01, True, "cpu", time.perf_counter(),
                   root=root)
    assert got["correct"] is True
    assert got["metrics"]["gather.logged_calls"]["value"] >= 1
    assert got["metrics"]["flat.ran"]["value"] == 1.0
