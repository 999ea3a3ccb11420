"""The ``crops`` source's pool (square crops at the configuration's
``img_res`` with 49 normalised keypoints, an SMPL pose, shape and gender,
drawn on the device from the seed), each crop with the person box it was
cut from: ``box`` (1, 5) as ``(cx, cy, b, w, h)``, the box's centre and size
in a frame of ``width`` x ``height`` pixels, drawn from a stream of the seed
of its own (``harness/cliff.py:boxes``).

``spec``: ``pool``, the number of distinct frames; ``width``, ``height``;
``centre_share``, the central share of the frame the centres are uniform
over, in x and y; ``size``, the range of box sizes b in pixels."""

from __future__ import annotations

import os

from perfbench.harness import cliff as H
from perfbench.harness import found
from perfbench.harness.inputs import generator

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def make(seed: int, spec: dict, cfg: dict, device) -> list[dict]:
    pool = found.module("sources", "crops", ROOT).make(seed, spec, cfg,
                                                        device)
    boxes = H.boxes(len(pool), spec, generator(seed, H.BOXES, device), device)
    return [dict(f, box=boxes[i:i + 1]) for i, f in enumerate(pool)]
