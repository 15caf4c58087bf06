"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (``vnlb_tpu_torch`` is the program,
``vnlb_tpu`` is not allowed), and the plain reference, the work models,
the traffic generator and its modules, and the metric readers load
nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import run
from perfbench.harness import spec

BLOCKED = ("jax", "jaxlib", "flax", "vnlb_tpu")

CHILD = r"""
import importlib.abc, json, sys
BLOCKED = %r

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked " + name)
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, %r)
import perfbench.reference, perfbench.work.models, perfbench.traffic.generator
import perfbench.harness.check, perfbench.harness.stats, perfbench.harness.spec
tops = lambda: sorted({m.split(".")[0] for m in sys.modules})
before = tops()
import perfbench.run as run
from perfbench.harness import loop, spec, trace
for m in spec.benchmark()["per_layer"]:
    spec.metric_reader(m["name"])
from perfbench.traffic import generator
for w in spec.benchmark()["workloads"]:
    mix = spec.cell(w["name"]).traffic
    for kind in generator.KINDS:
        generator.module(mix, kind)
plugins = tops()
import vnlb_tpu_torch
print(json.dumps(dict(before=before, plugins=plugins, after=tops(),
                      found=run.forbidden_modules())))
"""


def test_blocked_imports_in_a_subprocess():
    out = subprocess.run([sys.executable, "-c",
                          CHILD % (BLOCKED, str(spec.ROOT))],
                         capture_output=True, text=True, timeout=300,
                         cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "vnlb_tpu_torch" not in got["before"]
    assert "vnlb_tpu_torch" not in got["plugins"]
    assert "vnlb_tpu_torch" in got["after"]
    assert not set(got["after"]) & set(BLOCKED)
    assert got["found"] == []


@pytest.mark.parametrize("modules,found", [
    ({"vnlb_tpu_torch", "vnlb_tpu_torch.api", "torch"}, []),
    ({"vnlb_tpu", "vnlb_tpu.api"}, ["vnlb_tpu"]),
    ({"jax.numpy", "jaxtyping", "flaxen"}, ["jax"]),
    ({"jaxlib", "flax.linen"}, ["flax", "jaxlib"]),
])
def test_forbidden_by_whole_top_level_name(modules, found):
    assert run.forbidden_modules(modules) == found


def imports_of(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


HARNESS = [p for p in spec.BENCH_DIR.rglob("*.py")
           if "tests" not in p.relative_to(spec.BENCH_DIR).parts]


@pytest.mark.parametrize("path", HARNESS,
                         ids=lambda p: str(p.relative_to(spec.BENCH_DIR)))
def test_sources_import_no_jax(path):
    tops = set(imports_of(path))
    assert not tops & set(BLOCKED)
    rel = path.relative_to(spec.BENCH_DIR).parts[0]
    if rel in ("reference", "work", "traffic", "metrics"):
        assert "vnlb_tpu_torch" not in tops
