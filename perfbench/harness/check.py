"""The comparison that decides ``correct``.

Adaptation is chaotic: two float32 runs of the same stream drift apart
within a dozen frames, so a window's outputs cannot be held against a
reference run over the whole window.  The check therefore follows the
program one step at a time:

* the start: the reference adapts from the seeded weights it was given
  over the first frames, and its outputs and weights are held against the
  program's;
* sampled window frames: the program's state just before the frame
  (weights, teacher, Adam moments and count, motion-history ring, retrieval
  generator, frame count) is copied on the device; the reference takes that
  copy through the same frame, and its outputs and resulting weights are
  held against what the program produced for the frame and the state it
  left.

Numbers compared (each the worst over the compared frames):

* ``pred_gap``: worst over vertices, camera, rotations and shape of the
  largest absolute difference over the reference's largest magnitude;
* ``metric_gap``: worst relative difference of MPJPE, PA-MPJPE and PVE,
  of the lower-level record and of every update's record (cells with
  ground truth);
* ``loss_gap``: worst relative difference of the lower and upper losses,
  their terms and every update's loss;
* ``adam_gap``: the norm of the two sides' difference over the reference's
  norm, over Adam's first and second moments of every leaf after the step.
  The moments carry each gradient at full relative precision.  The whole
  tree is taken, not its worst leaf: two float32 evaluations on the card
  differ in the stem's and layer1's gradients by up to 3 % (their
  reduction order is not fixed), as much as TF32 moves them;
* ``param_gap`` and ``teacher_gap``: the change the step made to the
  weights, and to the teacher, on each side (after less before, the before
  being the program's copy, or the seeded weights at the start): the
  median leaf's norm of the two changes' difference over the norm of the
  reference's.  These hold the update rule itself (learning rate, bias
  correction, eps, the EMA's alpha), which the moments do not see;
* ``updates_mismatch``: frames whose number of updates differs (exact);
* ``overlay_gap``: share of the overlay's pixels that differ (the webcam
  path).

In ``adam_gap``, ``param_gap`` and ``teacher_gap``, leaves whose first
reference gradient of the step is under a thousandth of the median leaf's
are left out: their moments and changes are round-off.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# -- the program's state, copied ---------------------------------------------

def snapshot(state, out: dict | None = None) -> dict:
    """A device copy of a ``BilevelEngine`` state: one flat buffer of
    weights, teacher and Adam moments and the motion-history ring (written
    into ``out`` when given, buffers from ``snapshot_buffer``), plus the
    generator's state and the counters.  No host sync."""
    names = list(state.params)
    ps = list(state.params.values())
    opt = state.optimizer
    st0 = opt.state.get(ps[0], {})
    m = [opt.state[p]["exp_avg"] if p in opt.state else torch.zeros_like(p)
         for p in ps]
    v = [opt.state[p]["exp_avg_sq"] if p in opt.state else torch.zeros_like(p)
         for p in ps]
    tensors = ps + list(state.teacher_params.values()) + m + v
    out = out or {}
    flat = torch.cat([t.detach().reshape(-1) for t in tensors],
                     out=out.get("flat"))
    hist = {}
    for k in ("hist_images", "hist_j2d"):
        x = getattr(state, k)
        hist[k] = out[k].copy_(x) if k in out else x.clone()
    return {
        "flat": flat, "names": names, "shapes": [tuple(p.shape) for p in ps],
        "t": float(st0["step"]) if "step" in st0 else 0.0,
        "gen": state.rng.get_state(), "step": int(state.step), **hist,
    }


def hist_like(state) -> dict:
    """The shapes and types of a state's motion-history ring."""
    return {k: (tuple(getattr(state, k).shape), getattr(state, k).dtype)
            for k in ("hist_images", "hist_j2d")}


def snapshot_buffer(params: dict, hist: dict) -> dict:
    """Room for one snapshot of a state over ``params`` whose ring is
    ``hist`` (``hist_like``), made before the window so that the window
    allocates nothing for the check."""
    n = sum(p.numel() for p in params.values())
    dev = next(iter(params.values())).device
    out = {"flat": torch.empty(4 * n, device=dev)}
    for k, (shape, dtype) in hist.items():
        out[k] = torch.empty(shape, dtype=dtype, device=dev)
    return out


def split(snap: dict) -> tuple[dict, dict, dict, dict]:
    """(weights, teacher, m, v) dicts of a snapshot."""
    out, i = [], 0
    sizes = [math.prod(s) for s in snap["shapes"]]
    for _ in range(4):
        d = {}
        for name, shape, n in zip(snap["names"], snap["shapes"], sizes):
            d[name] = snap["flat"][i:i + n].reshape(shape)
            i += n
        out.append(d)
    return tuple(out)


def ref_state(snap: dict, ctx, device):
    """A reference state built from a copy of the program's state."""
    from perfbench.reference.step import State

    p, t, m, v = split(snap)
    gen = torch.Generator(device=device)
    gen.set_state(snap["gen"])
    c = lambda d: {k: x.clone() for k, x in d.items()}
    return State(params=c(p), teacher=c(t), m=c(m), v=c(v), t=snap["t"],
                 hist_images=snap["hist_images"].clone(),
                 hist_j2d=snap["hist_j2d"].clone(), step=snap["step"],
                 gen=gen)


# -- the program's outputs in the reference's terms ----------------------------

def program_record(out: dict) -> dict:
    n = int(out["optim_steps"]) + 1
    rec = {k: out[k] for k in ("verts", "rotmat", "beta", "cam")}
    rec["n_updates"] = n
    rec["per_step_loss"] = out["per_step_loss"][:n]
    for level in ("lower", "upper"):
        for k, x in out[level].items():
            rec[f"{level}_{'loss' if k == 'loss' else k}"] = x
    for k in ("mpjpe", "pampjpe", "pve", "lower_0_mpjpe", "lower_0_pampjpe"):
        if k in out:
            rec[k] = out[k]
    if "per_step_mpjpe" in out:
        rec["per_step_metrics"] = torch.stack(
            [out["per_step_mpjpe"][:n], out["per_step_pampjpe"][:n],
             out["per_step_pve"][:n]], 1)
    return rec


# -- the numbers -------------------------------------------------------------

def _rel(a, b, floor=1e-12):
    a = torch.as_tensor(a, dtype=torch.float64)
    b = torch.as_tensor(b, dtype=torch.float64).to(a.device)
    return float(((a - b).abs() / torch.clamp(b.abs(), min=floor)).max())


def output_gaps(prog: dict, ref: dict, compute_metrics: bool,
                detail: dict | None = None) -> dict:
    """pred_gap, loss_gap, metric_gap and updates_mismatch of one frame."""
    g = {}
    g["pred_gap"] = max(
        float((prog[k].double() - ref[k].double()).abs().max()
              / torch.clamp(ref[k].double().abs().max(), min=1e-12))
        for k in ("verts", "cam", "rotmat", "beta"))
    g["updates_mismatch"] = int(prog["n_updates"] != ref["n_updates"])
    keys = [k for k in ref if (k.startswith("lower_") or k.startswith("upper_"))
            and k in prog and not k.startswith("lower_0_")]
    losses = [_rel(prog[k], ref[k], 1e-9) for k in keys]
    if detail is not None:
        for k, v in zip(keys, losses):
            detail[k] = max(detail.get(k, 0), v)
    if not g["updates_mismatch"]:
        losses.append(_rel(prog["per_step_loss"], ref["per_step_loss"], 1e-9))
    g["loss_gap"] = max(losses)
    if compute_metrics:
        ms = [_rel(prog[k], ref[k], 1e-6)
              for k in ("mpjpe", "pampjpe", "pve", "lower_0_mpjpe",
                        "lower_0_pampjpe") if k in ref]
        if not g["updates_mismatch"] and "per_step_metrics" in ref:
            ms.append(_rel(prog["per_step_metrics"], ref["per_step_metrics"],
                           1e-6))
        g["metric_gap"] = max(ms)
    bad = any(not bool(torch.isfinite(prog[k]).all())
              for k in ("verts", "cam"))
    if bad:
        g = {k: math.inf for k in g}
    return g


def kept_leaves(grad_norms: dict) -> list:
    """Leaves whose first reference gradient is at least a thousandth of
    the median leaf's."""
    gn = torch.stack([grad_norms[k] for k in grad_norms])
    med = gn.median()
    return [k for k in grad_norms if grad_norms[k] >= 1e-3 * med]


def _leaf_gaps(pairs, detail: dict | None, tag: str):
    """Each ``(key, a, r)`` leaf's ||a - r|| and ||r||, in float64."""
    out = []
    for key, a, r in pairs:
        r = r.double()
        d = float(torch.linalg.vector_norm(a.double() - r))
        n = float(torch.linalg.vector_norm(r))
        out.append((d, n))
        if detail is not None:
            detail[tag + key] = max(detail.get(tag + key, 0),
                                    d / max(n, 1e-30))
    return out


def tree_gap(pairs, detail: dict | None = None, tag: str = "") -> float:
    """||a - r|| / ||r|| over the tree of ``(key, a, r)`` leaves."""
    g = _leaf_gaps(pairs, detail, tag)
    return math.sqrt(sum(d * d for d, _ in g)
                     / max(sum(n * n for _, n in g), 1e-300))


def adam_gap(prog_after: tuple, ref_after: tuple, keep: list,
             detail: dict | None = None) -> float:
    """Adam's two moments after the step (``*_after`` are (m, v) dicts)."""
    return tree_gap([(k, prog_after[i][k], ref_after[i][k])
                     for i in range(2) for k in keep], detail,
                    "adam:")


def delta_gap(before: dict, prog_after: dict, ref_after: dict, keep: list,
              detail: dict | None = None, tag: str = "") -> float:
    """The change of each leaf over the step on each side, (after -
    before), compared leaf by leaf: the median leaf's ||d_prog - d_ref|| /
    ||d_ref||.  The whole tree's reading swings tenfold between two runs of
    one seed (elements whose gradient is near round-off, which Adam scales
    to a full step, and GroupNorm weights near 1, whose change float32 holds
    to a few percent); the median leaf's does not.  ``detail`` also gets
    the whole tree's reading."""
    g = _leaf_gaps([(k, prog_after[k].double() - before[k].double(),
                     ref_after[k].double() - before[k].double())
                    for k in keep], detail, tag)
    if detail is not None:
        tree = math.sqrt(sum(d * d for d, _ in g)
                         / max(sum(n * n for _, n in g), 1e-300))
        detail[tag + "(tree)"] = max(detail.get(tag + "(tree)", 0), tree)
    return float(np.median([d / max(n, 1e-30) for d, n in g]))


def overlay_gap(prog_img: np.ndarray, ref_img: np.ndarray) -> float:
    return float((prog_img != ref_img).any(-1).mean())


def merge(acc: dict, gaps: dict) -> dict:
    for k, v in gaps.items():
        acc[k] = max(acc.get(k, 0), v)
    return acc


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}})."""
    names = [k for k in limits if not k.startswith("_")]
    shown = {k: {"value": numbers[k], "limit": limits[k]["limit"]}
             for k in names if k in numbers}
    ok = all(k in numbers for k in names) and all(
        math.isfinite(v["value"]) and v["value"] <= v["limit"]
        for v in shown.values())
    return ok, shown
