"""The one generator of the benchmark's traffic: a pool of noisy clips (and
their flows) made from ``--seed`` and a traffic mix's parameters, and the
draw of the window calls that are compared with the reference.

A traffic mix (``perfbench/traffic/<name>.json``) holds:

* ``frames``: frames per clip; the frame size and sigma come from the
  configuration;
* ``content``: the module ``perfbench/traffic/content/<content>.py`` that
  makes a clean clip (``make(mix, t, h, w, rng)``), with its own keys in
  the mix (``synthetic_video``: ``motion``);
* ``flow``: the module ``perfbench/traffic/flow/<flow>.py`` that makes the
  flows handed to the program with the clip (``make(mix, clean)``: None
  or (fflow, bflow));
* ``entry``: the module ``perfbench/traffic/entry/<entry>.py`` whose
  ``program`` is one timed call and whose ``reference`` is the plain
  reference's answer to the same request;
* ``pool``: clips made per run, sent round robin;
* ``check_calls``: how many calls of the window are compared with the
  reference, drawn from the seed over the whole window.

A new content, flow or entry is a new module found by its name.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from ..harness import spec

KINDS = ("content", "flow", "entry")


class Clip(NamedTuple):
    """One request: the noisy clip (T, 3, H, W) f32 on [0, 255], its clean
    source and its flows ((fflow, bflow), or None)."""

    noisy: np.ndarray
    clean: np.ndarray
    flows: Optional[Tuple[np.ndarray, np.ndarray]]


def seed_words(seed: int) -> List[int]:
    """Any whole number as two unsigned 32-bit words (negative seeds wrap
    modulo 2**64), the entropy of every stream made from it."""
    s = seed % 2 ** 64
    return [s & 0xFFFFFFFF, s >> 32]


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator for one stream (clip, noise, sample) of a
    seed."""
    return np.random.default_rng(np.random.SeedSequence(
        seed_words(seed) + list(stream)))


def add_noise(clean: np.ndarray, sigma: float,
              rng: np.random.Generator) -> np.ndarray:
    return (clean + rng.normal(0.0, sigma, clean.shape)).astype(np.float32)


def module(mix: dict, kind: str, root: Path = spec.ROOT):
    """The content, flow or entry module the mix names."""
    return spec.plugin(f"traffic/{kind}", mix[kind], root)


def check_mix(mix: dict, root: Path = spec.ROOT) -> None:
    """Raise ValueError for a traffic mix the generator does not take."""
    for kind in KINDS:
        name = mix.get(kind)
        if not isinstance(name, str) or not spec.NAME_RE.match(name) or \
                not (Path(root) / "perfbench" / "traffic" / kind
                     / f"{name}.py").exists():
            raise ValueError(f"{kind} {name!r}: no module "
                             f"perfbench/traffic/{kind}/{name}.py")
    for key in ("frames", "pool", "check_calls"):
        if not isinstance(mix.get(key), int) or mix[key] < 1:
            raise ValueError(f"{key} must be a positive whole number")
    if mix["frames"] < 2:
        raise ValueError("a clip needs at least 2 frames")


def make_pool(mix: dict, height: int, width: int, sigma: float,
              seed: int, root: Path = spec.ROOT) -> List[Clip]:
    """``mix["pool"]`` clips of ``mix["frames"]`` frames, the same for the
    same seed; every clip of every seed has the same sizes."""
    check_mix(mix, root)
    content, flow = module(mix, "content", root), module(mix, "flow", root)
    pool = []
    for j in range(mix["pool"]):
        clean = content.make(mix, mix["frames"], height, width,
                             rng_for(seed, j, 0))
        noisy = add_noise(clean, sigma, rng_for(seed, j, 1))
        pool.append(Clip(noisy, clean, flow.make(mix, clean)))
    return pool


class Sample:
    """The window calls compared with the reference: a uniform draw of
    ``k`` calls over however many the window holds (a reservoir), from the
    seed.  ``offer(i, item)`` is called for calls 0, 1, ... in order and
    keeps ``item`` while call ``i`` is in the draw."""

    def __init__(self, k: int, seed: int):
        self.k, self.kept = k, {}
        self._rng = rng_for(seed, 1 << 20)

    def offer(self, i: int, item) -> None:
        if i < self.k:
            self.kept[i] = item
            return
        j = int(self._rng.integers(0, i + 1))
        if j < self.k:
            drop = sorted(self.kept)[j]
            del self.kept[drop]
            self.kept[i] = item
