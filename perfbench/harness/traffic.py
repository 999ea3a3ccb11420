"""A traffic mix is a data file of parameters, ``perfbench/traffic/<mix>.json``:

* ``entry``: how the window drives the program (``perfbench/entries/``);
* ``frames``: the frame source (``source``, in ``perfbench/sources/``) and
  its parameters;
* ``updates``: the gate's ``threshold`` (``null``: the configuration's)
  and ``caps``, a per-frame extra-update schedule (``dist``, in
  ``perfbench/schedules/``) and its parameters, or ``null``;
* ``warmup_frames``; ``check``: the frames the check compares;
  ``trace``: the traced segment, the same whatever the seed and whatever
  the window did.

This module reads a mix and hands its parameters, with the run's seed, to
the source and schedule it names.
"""

from __future__ import annotations

import json
import os

import numpy as np

from perfbench.harness import found


def load(name: str, root: str) -> dict:
    """The mix ``<root>/perfbench/traffic/<name>.json``."""
    with open(os.path.join(root, "perfbench", "traffic", f"{name}.json")) as f:
        mix = json.load(f)
    mix["name"] = name
    return mix


def frames(run) -> list:
    """The mix's frame pool for the run's seed, from its named source."""
    spec = run.mix["frames"]
    return found.module("sources", spec["source"], run.root).make(
        run.seed, spec, run.cfg, run.device)


def caps(run, n: int) -> np.ndarray:
    """(n,) extra-update caps for the run's seed, from the mix's named
    schedule."""
    spec = run.mix["updates"]["caps"]
    return found.module("schedules", spec["dist"], run.root).caps(
        spec, run.seed, n)


def sample_positions(seed: int, n_lo: int, k: int, caps=None) -> list[int]:
    """``k`` distinct window positions in ``[0, n_lo)`` whose outputs the
    check compares; with ``caps``, the first is the earliest position with
    the most updates, so the longest frame is always among them."""
    r = np.random.default_rng([int(seed) % (2 ** 63), 1])
    n_lo = max(int(n_lo), 1)
    pos = [int(x) for x in r.permutation(n_lo)[:k]]
    if caps is not None:
        top = int(np.argmax(caps[:n_lo]))
        pos = [top] + [p for p in pos if p != top][:k - 1]
    return sorted(pos)
