"""What a cell is, read from data: ``BENCHMARK.json`` at the root names the
cell's configuration and traffic mix; ``perfbench/configs/<config>.json``,
``perfbench/traffic/<traffic>.json`` and ``perfbench/workloads/<cell>.json``
(the limits of its correctness check) hold them; ``perfbench/metrics/
<metric>.py`` reads each per-layer metric, and ``perfbench/ranges/
<range>.json`` names each program entry the traced run puts a range
around.  A new cell, configuration, metric, range or traffic module is new
files and new entries, found by name."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import NamedTuple

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "host_clock")


class Cell(NamedTuple):
    """One workload of ``BENCHMARK.json`` with its files loaded."""

    name: str
    entry: dict          # the workloads entry
    config: dict         # perfbench/configs/<config>.json
    traffic: dict        # perfbench/traffic/<traffic>.json
    limits: dict         # perfbench/workloads/<cell>.json
    end_to_end: list     # the end-to-end metric entries this cell reports
    per_layer: list      # the per-layer metric entries this cell reports


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise ValueError(f"{what} {name!r}: a name is 1-64 letters, digits, "
                         f"'_', '.' and '-', starting with a letter, digit "
                         f"or '_'")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT_RE.match(unit):
        raise ValueError(f"unit {unit!r}: 1-16 letters, digits, '_', '/', "
                         f"'%', '.' and '-'")
    return unit


def reports(metric: dict, cell: str) -> bool:
    """Whether ``metric`` is reported in ``cell``: every cell, or those its
    ``workloads`` key lists."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell named ``name``, its files read; ValueError for a name
    ``BENCHMARK.json`` does not hold."""
    root = Path(root)
    bench = benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise ValueError(f"no workload {name!r} in BENCHMARK.json; cells: "
                         f"{sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf_entry = configs[check_name(entry["config"], "config")]
    config = load_json(root / conf_entry["file"])
    traffic = load_json(root / "perfbench" / "traffic"
                        / f"{check_name(entry['traffic'], 'traffic')}.json")
    limits_path = root / "perfbench" / "workloads" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    return Cell(name=check_name(name, "workload"), entry=entry, config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if reports(m, name)])


def plugin(kind: str, name: str, root: Path = ROOT):
    """The module ``perfbench/<kind>/<name>.py``, loaded from its file."""
    path = Path(root) / "perfbench" / kind / f"{check_name(name, kind)}.py"
    tag = re.sub(r"[^A-Za-z0-9_]", "_", f"{kind}_{name}")
    mod_spec = importlib.util.spec_from_file_location(f"perfbench_{tag}",
                                                      path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(record)`` function of per-layer metric ``name``, from
    ``perfbench/metrics/<name>.py``."""
    return plugin("metrics", name, root).read


def ranges(root: Path = ROOT) -> dict:
    """{range name: its ``perfbench/ranges/<range>.json`` (``module``,
    ``attribute``, ``depth``: 1 for the call's own entry, more for each
    layer down)}."""
    return {check_name(p.stem, "range"): load_json(p)
            for p in sorted((Path(root) / "perfbench" / "ranges")
                            .glob("*.json"))}
