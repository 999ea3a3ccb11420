"""The comparison of the program's side with the reference's.

A side is what one implementation gives for the compared frames, as the
cell's entry (``perfbench/entries/``) builds it: ``{"start": part,
"samples": {position: part}}``, where a part is

* ``recs``: the records of its frames (one for a sampled frame, the first
  frames' for the start), in the reference's terms;
* ``after``: (weights, teacher, m, v) dicts after them;
* ``before``: (weights, teacher) dicts before them, the program's copy or
  the seeded weights (the reference's side only);
* ``grad_norms``: each leaf's first gradient norm (the reference's side).

The reference's side is computed in float32 with TF32 off, or with TF32
on for the control.
"""

from __future__ import annotations

import contextlib
import math

import torch

from perfbench.harness import check


@contextlib.contextmanager
def tf32(on: bool):
    be = torch.backends
    saved = (be.cuda.matmul.allow_tf32, be.cudnn.allow_tf32)
    be.cuda.matmul.allow_tf32 = be.cudnn.allow_tf32 = bool(on)
    try:
        yield
    finally:
        be.cuda.matmul.allow_tf32, be.cudnn.allow_tf32 = saved


def part(recs, after, before=None, grad_norms=None) -> dict:
    return {"recs": recs if isinstance(recs, list) else [recs],
            "after": tuple(after), "before": before,
            "grad_norms": grad_norms}


def compare(cfg: dict, chk: dict, a: dict, ref: dict,
            detail: dict | None = None) -> dict:
    """The check's numbers of side ``a`` against the reference side;
    ``detail``, when given, collects each number's worst parts."""
    cm = cfg["compute_metrics"]
    nums = {}
    pairs = [(a["start"], ref["start"])] if "start" in a and "start" in ref \
        else []
    pairs += [(a["samples"][s], ref["samples"][s]) for s in chk["samples"]]
    for x, y in pairs:
        for px, py in zip(x["recs"], y["recs"]):
            check.merge(nums, check.output_gaps(px, py, cm, detail))
            if "overlay" in py:
                check.merge(nums, {"overlay_gap": check.overlay_gap(
                    px["overlay"], py["overlay"])})
        keep = check.kept_leaves(y["grad_norms"])
        (xp, xt, xm, xv), (yp, yt, ym, yv) = x["after"], y["after"]
        bp, bt = y["before"]
        check.merge(nums, {
            "adam_gap": check.adam_gap((xm, xv), (ym, yv), keep, detail),
            "param_gap": check.delta_gap(bp, xp, yp, keep, detail, "param:"),
            "teacher_gap": check.delta_gap(bt, xt, yt, keep, detail,
                                           "teacher:")})
    nums["compared_frames"] = sum(len(x["recs"]) for x, _ in pairs)
    if "start" not in a or "start" not in ref:
        nums["pred_gap"] = math.inf     # the start was not compared
    return nums
