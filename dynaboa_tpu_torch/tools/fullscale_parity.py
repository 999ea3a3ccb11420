#!/usr/bin/env python
"""Full-width composed parity of the port against a recorded run of the JAX
package (counterpart of the JAX package's ``tools/fullscale_parity.py``).

The JAX engine's run is recorded once, on the CPU, by
``tests/torch_fullscale_golden.py`` into ``assets/fullscale_jax.npz``.  This
module runs the same inputs through the port's ``BilevelEngine`` on any
device and holds the result against that record.  It imports nothing of JAX.

The recipe.  Every input comes from a numpy seed, as the port's CPU parity
tests make them: the frames (``make_frames``), the three synthetic SMPL
bodies (seeds 10, 11, 12) and the Dirichlet H36M regressor (seed 5), the
synthetic GMM prior (seed 4), and a store of 6 singleton clusters over the
first 6 exemplars of ``synthetic_store`` seed 6, whose draws are
deterministic in both packages.  The HMR weights
are drawn with ``np.random.default_rng`` in the scales of
``models/hmr.py:init_weights_``, leaf by leaf in the sorted order of the
port's parameter names; the JAX side takes the same arrays.  Numpy, not a
``torch.Generator``, so that the draw does not depend on torch's version.
The record keeps a checksum of every initial leaf: a mismatch is a fault of
the recipe, not of the port.

Three arms of 12 frames at full width (ResNet-50-GN, 224^2, regressor 1024,
V = 6890), metrics on, the lower-level record on, the port's no-grad
decodes through the skinning kernel (``use_pallas_lbs``; the JAX side
decodes with its eager ``lbs``):

  base          inner_step 1, interval 2, optim_steps 2, retrieval off,
                threshold -1: every update is taken
  retrieval_on  the same over the 6-cluster store, retrieval on: the
                argmax moves between clusters across the frames
  gate_live     the 3DPW defaults (optim_steps 7, interval 5, retrieval on)
                at the default threshold 3.1e-4: the dynamic gate decides
                how many updates each frame takes (frame 6 takes an extra
                one, the others none)

Frame 6 carries keypoints SPIKE_SCALE times farther out: after quiet frames
its loss spikes, Adam's step grows past lr and the gate opens.
The cluster centres are the exemplars' own pooled features at the initial
weights, their spread about the frames' mean direction amplified
(``cluster_centers``), so the argmax moves between clusters.

The record also holds the reference's own spread: the JAX engine again
from the initial weights with every weight one float32 ulp up or down
(``ulp_moved``), and the other way, each check's gap to the central run
per frame.  ``compare`` holds every frame of every check, and every single
value, to the larger of its bound and SPREAD_FACTOR times that spread's
running maximum: the composed run amplifies fp32 rounding from frame to
frame, past some output bounds in JAX against itself (ROADMAP §3).

Usage:
  python -m dynaboa_tpu_torch.tools.fullscale_parity [--device cuda]
      [--record path] [--arms base retrieval_on gate_live]

prints one JSON object and exits non-zero if a bound fails.  ``--device``
defaults to ``cuda`` and raises without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

RECIPE_VERSION = 2
RECORD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "fullscale_jax.npz")


class Size(NamedTuple):
    img: int
    width: int
    layers: tuple
    rdim: int
    nv: int

    @property
    def feat(self) -> int:
        return self.width * 8 * 4


SIZES = {"full": Size(224, 64, (3, 4, 6, 3), 1024, 6890),
         "tiny": Size(32, 16, (1, 1, 1, 1), 128, 256)}
N_FRAMES = 12
WEIGHT_SEED, FRAME_SEED, COORD_SEED = 0, 3, 7
N_CLUSTERS = 6
N_COORDS = 512          # recorded coordinates per leaf, at most
THRESHOLD = 3.1e-4      # AdaptConfig's default cos_sim_threshold
SPIKE_FRAMES, SPIKE_SCALE = (6,), 8.0
CENTER_GAIN = 3.0       # centre = mean + CENTER_GAIN * |mean| * direction

# each arm's AdaptConfig fields beyond the defaults, and its gate threshold
ARMS = {
    "base": (dict(inner_step=1, interval=2, optim_steps=2, retrieval=False),
             -1.0),
    "retrieval_on": (dict(inner_step=1, interval=2, optim_steps=2), -1.0),
    "gate_live": ({}, THRESHOLD),
}

# the bounds (the JAX full-scale record's, docs/PARITY.md)
LOSS_RTOL, LOSS_ATOL = 5e-3, 1e-4
SIM_ATOL = 5e-4
METRIC_ATOL_MM = 0.05
VERTS_ATOL_M = 1e-4
DRIFT_FACTOR = 4.0      # weights within DRIFT_FACTOR * n_updates * lr
NORM_RATIO_TOL = 0.1    # each leaf's update norm within 0.9-1.1x JAX's
GATE_MARGIN_FACTOR = 10.0
CHECKSUM_RTOL = 1e-7
ULP_SEED = 8            # the coins of ``ulp_moved``
# A check's allowance on a frame: the larger of its bound and SPREAD_FACTOR
# times the reference's own spread (JAX from every weight one ulp up or
# down, and the other way) up to that frame.  The factor covers the
# scatter of two draws.
SPREAD_FACTOR = 4.0
METRIC_KEYS = ("mpjpe", "pampjpe", "pve", "lower_0_mpjpe", "lower_0_pampjpe",
               "per_step_mpjpe", "per_step_pampjpe", "per_step_pve")


# -- the recipe ---------------------------------------------------------------

def hmr_for(size: Size):
    from dynaboa_tpu_torch.models.hmr import HMR

    return HMR(layers=size.layers, width=size.width, regressor_dim=size.rdim)


def draw_weights(size: Size, seed: int = WEIGHT_SEED) -> dict[str, np.ndarray]:
    """The HMR parameters, name -> float32 array, drawn leaf by leaf in
    sorted name order: convs normal(0, sqrt(2 / (kh*kw*out))), GroupNorm
    (1, 0), the decoder heads xavier-uniform with gain 0.01 and zero bias,
    fc1/fc2 uniform(+-1/sqrt(fan_in)) for weight and bias."""
    net = hmr_for(size)
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in sorted(net.named_parameters()):
        mod_name, leaf = name.rsplit(".", 1)
        m = net.get_submodule(mod_name)
        shape = tuple(p.shape)
        if isinstance(m, torch.nn.Conv2d):
            kh, kw = m.kernel_size
            a = rng.normal(0.0, np.sqrt(2.0 / (kh * kw * m.out_channels)),
                           size=shape)
        elif isinstance(m, torch.nn.GroupNorm):
            a = np.ones(shape) if leaf == "weight" else np.zeros(shape)
        elif mod_name in ("decpose", "decshape", "deccam"):
            bound = 0.01 * np.sqrt(6.0 / (m.in_features + m.out_features))
            a = (rng.uniform(-bound, bound, size=shape) if leaf == "weight"
                 else np.zeros(shape))
        else:
            bound = 1.0 / np.sqrt(m.in_features)
            a = rng.uniform(-bound, bound, size=shape)
        out[name] = a.astype(np.float32)
    return out


def checksums(weights: dict[str, np.ndarray]) -> np.ndarray:
    """(L, 2) float64: each leaf's sum and sum of squares, sorted names."""
    return np.array([[w.astype(np.float64).sum(),
                      np.square(w.astype(np.float64)).sum()]
                     for _, w in sorted(weights.items())])


def coordinates(weights: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Up to N_COORDS seeded flat indices per leaf (all of a small leaf)."""
    rng = np.random.default_rng(COORD_SEED)
    out = {}
    for name, w in sorted(weights.items()):
        n = w.size
        out[name] = (np.arange(n) if n <= N_COORDS else
                     np.sort(rng.choice(n, N_COORDS, replace=False)))
    return out


def make_frames(n: int, img: int, seed: int = FRAME_SEED) -> list[dict]:
    """n labeled frames (image, keypoints, GT pose and shape, alternating
    gender) as numpy, the recipe of the CPU parity tests; the keypoints of
    SPIKE_FRAMES lie SPIKE_SCALE times farther out."""
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        fr = dict(
            image=rng.normal(size=(1, img, img, 3)).astype(np.float32),
            j2d=np.concatenate([rng.uniform(-1, 1, size=(1, 49, 2)),
                                np.ones((1, 49, 1))], -1).astype(np.float32),
            pose=rng.normal(scale=0.2, size=(1, 72)).astype(np.float32),
            betas=rng.normal(scale=0.3, size=(1, 10)).astype(np.float32),
            gender=np.asarray([i % 2], np.int32))
        if i in SPIKE_FRAMES:
            fr["j2d"][..., :2] *= SPIKE_SCALE
        frames.append(fr)
    return frames


def h36m_regressor(nv: int) -> np.ndarray:
    return np.random.default_rng(5).dirichlet(np.ones(nv), size=17).astype(
        np.float32)


def exemplar_bank(size: Size, device="cpu"):
    """The store's exemplars: the first N_CLUSTERS of ``synthetic_store``
    seed 6, one per cluster."""
    from dynaboa_tpu_torch.engine.retrieval import synthetic_store

    base = synthetic_store(6, device, img_res=size.img, feat_dim=size.feat)
    return base.bank.take(slice(0, N_CLUSTERS))


def cluster_centers(size: Size, weights: dict[str, np.ndarray],
                    n_frames: int) -> np.ndarray:
    """(N_CLUSTERS, feat) float32: each exemplar's pooled feature (tap 5) at
    the initial weights on the CPU, less the exemplars' mean, without its
    component along the frames' mean feature m, normalised, times
    CENTER_GAIN * |m|, plus m.  The record keeps the centres it was made
    with, and a run on another host takes them from there."""
    net = hmr_for(size)
    net.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()},
                        strict=False)
    net.eval()
    frames = np.concatenate([f["image"] for f in make_frames(n_frames,
                                                             size.img)])
    images = np.concatenate([frames, exemplar_bank(size).images.numpy()])
    with torch.no_grad():
        f5 = net(torch.as_tensor(images).permute(0, 3, 1, 2))[3][5]
    f5 = f5.double().numpy()
    m = f5[:n_frames].mean(0)
    mh = m / np.linalg.norm(m)
    d = f5[n_frames:] - f5[n_frames:].mean(0)
    d = d - np.outer(d @ mh, mh)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return (m + CENTER_GAIN * np.linalg.norm(m) * d).astype(np.float32)


def arm_config(arm: str, **overrides):
    """The port's AdaptConfig of an arm, and its gate threshold."""
    from dynaboa_tpu_torch.config import AdaptConfig

    fields, thr = ARMS[arm]
    return AdaptConfig(**{**fields, **overrides}), thr


# -- one run, reduced to what the record keeps --------------------------------

def summarize(outs: list[dict], start: dict, final: dict,
              teacher: dict) -> dict[str, np.ndarray]:
    """One arm's run as the record's arrays: per-frame step counts, losses,
    sims, upper aux terms and metrics, the first and last frame's vertices,
    and the final params and teacher at ``coordinates(start)`` with each
    leaf's update norm.  ``outs`` are the engine's outputs as numpy; the
    parameter dicts hold numpy arrays under the port's names."""
    r = {"optim_steps": np.array([int(o["optim_steps"]) for o in outs]),
         "lower_loss": np.array([float(o["lower"]["loss"]) for o in outs])}
    for k in sorted(outs[0]["upper"]):
        r[f"upper/{k}"] = np.array([float(o["upper"][k]) for o in outs])
    for k in ("per_step_loss", "per_step_sims", *METRIC_KEYS):
        r[k] = np.stack([np.asarray(o[k], np.float32) for o in outs])
    r["verts_first"] = np.asarray(outs[0]["verts"], np.float32)
    r["verts_last"] = np.asarray(outs[-1]["verts"], np.float32)
    coords = coordinates(start)
    names = sorted(start)
    r["params_at"] = np.concatenate(
        [final[k].reshape(-1)[coords[k]] for k in names]).astype(np.float32)
    r["teacher_at"] = np.concatenate(
        [teacher[k].reshape(-1)[coords[k]] for k in names]).astype(np.float32)
    r["update_norm"] = np.array([np.linalg.norm(
        final[k].astype(np.float64).ravel() - start[k].ravel())
        for k in names])
    return r


def run_meta(size: str, n_frames: int, weights: dict,
             centers: np.ndarray) -> dict:
    """What a record and a run share about their recipe."""
    return {"recipe_version": RECIPE_VERSION, "size": size,
            "n_frames": n_frames, "leaves": sorted(weights),
            "init_checksum": checksums(weights).tolist(),
            "centers_checksum": checksums({"c": centers}).tolist(),
            "coord_counts": [len(c) for _, c in
                             sorted(coordinates(weights).items())],
            "arms": {}}


@contextlib.contextmanager
def strict_fp32():
    """fp32 without TF32, deterministic cuDNN and algorithms (warn-only
    where an op has no deterministic implementation); restores the
    process's settings after."""
    be = torch.backends
    saved = (be.cudnn.allow_tf32, be.cuda.matmul.allow_tf32,
             be.cudnn.deterministic, be.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    be.cudnn.allow_tf32 = be.cuda.matmul.allow_tf32 = False
    be.cudnn.deterministic, be.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        (be.cudnn.allow_tf32, be.cuda.matmul.allow_tf32, be.cudnn.deterministic,
         be.cudnn.benchmark) = saved[:4]
        torch.use_deterministic_algorithms(saved[4], warn_only=saved[5])


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    return x


def ulp_moved(weights: dict, sign: int) -> dict:
    """The initial weights with every nonzero coordinate moved one float32
    ulp, up or down by a seeded coin per coordinate (``sign`` 1) or the
    other way (-1): one rounding of every weight, as a run that rounds
    otherwise leaves them after its first update.  (A uniform scale would
    not do: GroupNorm takes most of it out.)"""
    rng = np.random.default_rng(ULP_SEED)
    out = {}
    for k, v in sorted(weights.items()):
        d = sign * (2.0 * rng.integers(0, 2, size=v.shape) - 1.0)
        out[k] = np.where(v != 0, np.nextafter(v, (d * np.inf).astype(
            np.float32)), v).astype(np.float32)
    return out


def run_port(arm: str, device, size: str = "full", n_frames: int = N_FRAMES,
             weights: dict | None = None, centers: np.ndarray | None = None):
    """One arm through the port's engine on ``device`` under
    ``strict_fp32``.  Returns ``(arm_meta, arrays)``: the config and
    threshold, and ``summarize``'s arrays."""
    from dynaboa_tpu_torch.apps.common import require_device
    from dynaboa_tpu_torch.engine.bilevel import BilevelEngine, Frame
    from dynaboa_tpu_torch.engine.retrieval import build_store
    from dynaboa_tpu_torch.losses.priors import synthetic_gmm_prior
    from dynaboa_tpu_torch.metrics.eval import GenderedSMPL
    from dynaboa_tpu_torch.models.smpl import synthetic_smpl_model

    device = require_device(device)
    S = SIZES[size]
    cfg, thr = arm_config(arm, use_pallas_lbs=True)
    weights = draw_weights(S) if weights is None else weights
    if centers is None:
        centers = cluster_centers(S, weights, n_frames)
    net = hmr_for(S)
    net.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()},
                        strict=False)
    net = net.to(device).eval()
    smpls = GenderedSMPL(
        neutral=synthetic_smpl_model(10, device, num_vertices=S.nv),
        male=synthetic_smpl_model(11, device, num_vertices=S.nv),
        female=synthetic_smpl_model(12, device, num_vertices=S.nv),
        J_regressor_h36m=torch.as_tensor(h36m_regressor(S.nv), device=device))
    store = build_store(centers, [[i] for i in range(N_CLUSTERS)],
                        exemplar_bank(S, device))
    engine = BilevelEngine(cfg, net, synthetic_gmm_prior(4, device), smpls,
                           store)
    outs = []
    with strict_fp32():
        state = engine.init_state(dict(net.named_parameters()),
                                  img_res=S.img)
        for fr in make_frames(n_frames, S.img):
            state, out = engine.step(
                state, Frame(**{k: torch.as_tensor(v, device=device)
                                for k, v in fr.items()}),
                cos_sim_threshold=thr)
            outs.append(_numpy(out))
    final = {k: _numpy(v) for k, v in state.params.items()}
    teacher = {k: _numpy(v) for k, v in state.teacher_params.items()}
    return ({"config": dataclasses.asdict(cfg), "thr": thr},
            summarize(outs, weights, final, teacher))


def run_all(device, size: str = "full", n_frames: int = N_FRAMES,
            arms=tuple(ARMS), centers: np.ndarray | None = None) -> dict:
    """Every arm through the port on ``device`` (with the record's
    ``centers`` where given): ``{"meta": ..., "arms": {arm: arrays}}`` with
    each arm's seconds in the meta."""
    S = SIZES[size]
    weights = draw_weights(S)
    if centers is None:
        centers = cluster_centers(S, weights, n_frames)
    run = {"meta": run_meta(size, n_frames, weights, centers), "arms": {}}
    run["meta"].update(torch=torch.__version__, device=str(device))
    for arm in arms:
        t0 = time.perf_counter()
        meta, run["arms"][arm] = run_port(arm, device, size, n_frames,
                                          weights, centers)
        meta["seconds"] = time.perf_counter() - t0
        run["meta"]["arms"][arm] = meta
    return run


# -- the record on disk -------------------------------------------------------

def save_record(path: str, record: dict) -> None:
    arrays = {"meta": np.array(json.dumps(record["meta"])),
              "centers": np.asarray(record["centers"], np.float32)}
    for arm, fields in record["arms"].items():
        for k, v in fields.items():
            arrays[f"{arm}/{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_record(path: str = RECORD) -> dict:
    with np.load(path) as z:
        record = {"meta": json.loads(str(z["meta"])),
                  "centers": z["centers"], "arms": {}}
        for key in z.files:
            if key not in ("meta", "centers"):
                arm, field = key.split("/", 1)
                record["arms"].setdefault(arm, {})[field] = z[key]
    return record


# -- the comparison -----------------------------------------------------------

def _gaps(got, want, rel: bool = False, per_frame: bool = True) -> np.ndarray:
    """|got - want| (over its allowance LOSS_ATOL + LOSS_RTOL * |want| where
    ``rel``), the worst of each frame (axis 0) where ``per_frame``, else the
    worst of all as a (1,) array.  A shape mismatch or a non-finite value
    is an infinite gap."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    n = len(want) if per_frame else 1
    if got.shape != want.shape:
        return np.full(n, np.inf)
    if not n:
        return np.zeros(0)
    d = np.abs(got - want)
    if rel:
        d = d / (LOSS_ATOL + LOSS_RTOL * np.abs(want))
    d = np.where(np.isfinite(got), d, np.inf)
    return d.reshape(n, -1).max(1, initial=0.0)


def _check(field, gaps, bound, per_frame=True, **extra) -> dict:
    return {"field": field, "gaps": np.asarray(gaps, np.float64).reshape(-1),
            "bound": float(bound), "per_frame": per_frame, **extra}


def _fixed(field, value, bound, **extra) -> dict:
    """A check no spread can widen: step counts, the recipe."""
    return _check(field, [value], bound, per_frame=False, fixed=True, **extra)


def _decision_sims(sims, steps: int, optim_steps: int):
    """The sims the gate read: after update k it decides whether to go on,
    for every k it reached below the cap."""
    return sims[:min(steps + 1, optim_steps)]


def _recipe_checks(rmeta, pmeta, arm) -> list[dict]:
    same = (rmeta["recipe_version"] == pmeta["recipe_version"]
            and rmeta["size"] == pmeta["size"]
            and rmeta["n_frames"] == pmeta["n_frames"]
            and rmeta["leaves"] == pmeta["leaves"]
            and rmeta["coord_counts"] == pmeta["coord_counts"])
    rc, pc = rmeta["arms"][arm], pmeta["arms"][arm]
    ignore = ("use_pallas_lbs",)
    cfg_same = ({k: v for k, v in rc["config"].items() if k not in ignore}
                == {k: v for k, v in pc["config"].items() if k not in ignore}
                and rc["thr"] == pc["thr"])

    def rel(key):
        a, b = np.asarray(rmeta[key]), np.asarray(pmeta[key])
        return (float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-30)))
                if a.shape == b.shape else np.inf)

    return [_fixed("recipe/layout", 0.0 if same else 1.0, 0.0),
            _fixed("recipe/config", 0.0 if cfg_same else 1.0, 0.0),
            _fixed("recipe/init_checksum", rel("init_checksum"),
                   CHECKSUM_RTOL),
            _fixed("recipe/centers_checksum", rel("centers_checksum"),
                   CHECKSUM_RTOL)]


def spread(meta: dict, arm: str, central: dict, others: list[dict]) -> dict:
    """The reference's own spread in one arm: ``spread/<field>`` -> the
    largest gap of ``others`` (the arm from weights one ulp up and down) to
    ``central``, per frame or single as ``compare`` measures it, and
    ``spread_steps``, the others' step counts.  Where another run's step
    counts leave the central run's, its gaps stop there (NaN after: no
    spread, the bound alone)."""
    rec = {"meta": meta, "arms": {arm: central}}
    out: dict[str, np.ndarray] = {}
    for other in others:
        for c in _compare(rec, {"meta": meta, "arms": {arm: other}})[
                "arms"][arm]["checks"]:
            if not c.get("fixed"):
                k = f"spread/{c['field']}"
                g = np.full(len(central[c["field"]]) if c["per_frame"]
                            else 1, np.nan)
                g[:len(c["gaps"])] = c["gaps"]
                out[k] = np.fmax(out.get(k, g), g)
    out["spread_steps"] = np.stack([o["optim_steps"] for o in others])
    return out


def compare(record: dict, run: dict) -> dict:
    """Hold a port run against the JAX record.  Returns ``{"ok": bool,
    "arms": {arm: {"checks": [...], "steps": ..., "near_threshold":
    [...]}}}``; each check has ``field``, ``measured`` (its worst gap;
    losses: the worst gap over its rtol/atol allowance, bound 1),
    ``bound``, ``allowance`` (the largest it was held to), ``share`` (the
    worst gap over its allowance on the same frame) and ``ok``.

    Every frame of every check, and every single value, is held to the
    larger of its bound and SPREAD_FACTOR times the reference's own spread
    (the record's ``spread/<field>``) up to that frame; step counts and the
    recipe to their bounds.

    Arms with every update taken are held on all frames.  In the gate arm
    a frame whose JAX gate margins |(1 - sim) - threshold| all exceed
    GATE_MARGIN_FACTOR times the largest sim gap of the other arms must
    take the same number of updates; a frame with a smaller margin is
    listed under ``near_threshold`` and is not a fault.  After a listed
    frame whose counts differ, the two runs have split, and the later
    frames and the weights are not compared."""
    result = _compare(record, run)
    for arm, a in result["arms"].items():
        R = record["arms"][arm]
        for c in a["checks"]:
            g = c.pop("gaps")
            s = np.zeros(len(g))
            if not c.get("fixed"):
                rs = np.asarray(R.get(f"spread/{c['field']}", s), np.float64)
                rs = np.where(np.isfinite(rs), rs, 0.0).reshape(-1)[:len(g)]
                s[:len(rs)] = rs
            allow = np.maximum(c["bound"],
                               SPREAD_FACTOR * np.maximum.accumulate(s))
            c["measured"] = float(g.max(initial=0.0))
            c["allowance"] = float(allow.max(initial=c["bound"]))
            c["ok"] = bool(np.all(g <= allow))
            with np.errstate(divide="ignore", invalid="ignore"):
                share = np.where(allow > 0, g / allow, np.where(g > 0, np.inf,
                                                                0.0))
            c["share"] = _num(share.max(initial=0.0))
            wide = np.flatnonzero(allow > c["bound"])
            if len(wide):
                c["widened_from"] = int(wide[0])
    result["ok"] = all(c["ok"] for a in result["arms"].values()
                       for c in a["checks"])
    return result


def _num(x):
    return float(x) if np.isfinite(x) else None


def _compare(record: dict, run: dict) -> dict:
    """``compare``'s checks of ``run`` against ``record``, each with its
    gaps per frame (or its single gap), before any allowance."""
    rmeta, pmeta = record["meta"], run["meta"]
    leaves = rmeta["leaves"]
    ends = np.cumsum(rmeta["coord_counts"])
    result = {"arms": {}}
    sim_gap = 0.0
    # the arms with every update taken first: their sim gaps set the gate
    # arm's margin floor
    for arm in sorted(run["arms"], key=lambda a: ARMS[a][1] >= 0):
        R, P = record["arms"][arm], run["arms"][arm]
        meta = rmeta["arms"][arm]
        lr, thr = meta["config"]["lr"], meta["thr"]
        optim_steps = meta["config"]["optim_steps"]
        checks = _recipe_checks(rmeta, pmeta, arm)
        rs, ps = R["optim_steps"], P["optim_steps"]
        n = len(rs)
        near, split, bad_steps = [], None, 0
        gated = thr >= 0
        floor = GATE_MARGIN_FACTOR * sim_gap
        for i in range(n):
            excused = False
            if gated:
                margins = np.abs(1.0 - _decision_sims(
                    R["per_step_sims"][i], int(rs[i]), optim_steps) - thr)
                if margins.min(initial=np.inf) <= floor:
                    excused = True
                    near.append({"frame": i, "jax_steps": int(rs[i]),
                                 "port_steps": int(ps[i]),
                                 "min_margin": float(margins.min()),
                                 "jax_sims": R["per_step_sims"][i].tolist(),
                                 "port_sims": P["per_step_sims"][i].tolist()})
            if rs[i] != ps[i]:
                bad_steps += int(not excused)
                split = i if split is None else split
                if gated:
                    break
        checks.append(_fixed("optim_steps", bad_steps, 0,
                             margin_floor=floor if gated else None))
        # past a split the two runs adapt different weights
        m = n if split is None else split
        fr = slice(0, m)
        checks.append(_check("lower_loss", _gaps(
            P["lower_loss"][fr], R["lower_loss"][fr], rel=True), 1.0))
        for k in sorted(x for x in R if x.startswith("upper/")):
            got = P[k][fr] if k in P else np.full(m, np.nan)
            checks.append(_check(k, _gaps(got, R[k][fr], rel=True), 1.0))
        checks.append(_check("per_step_loss", _gaps(
            P["per_step_loss"][fr], R["per_step_loss"][fr], rel=True), 1.0))
        sims = _check("per_step_sims", _gaps(
            P["per_step_sims"][fr], R["per_step_sims"][fr]), SIM_ATOL)
        checks.append(sims)
        if not gated:
            sim_gap = max(sim_gap, sims["gaps"].max(initial=0.0))
        for k in METRIC_KEYS:
            checks.append(_check(k, _gaps(P[k][fr], R[k][fr]),
                                 METRIC_ATOL_MM))
        if m:
            checks.append(_check("verts_first", _gaps(
                P["verts_first"], R["verts_first"], per_frame=False),
                VERTS_ATOL_M, per_frame=False))
        if split is None:
            checks.append(_check("verts_last", _gaps(
                P["verts_last"], R["verts_last"], per_frame=False),
                VERTS_ATOL_M, per_frame=False))
            bound = DRIFT_FACTOR * int(np.sum(rs + 1)) * lr
            for field in ("params_at", "teacher_at"):
                d = np.abs(P[field].astype(np.float64) - R[field])
                worst = int(np.argmax(d)) if d.size else 0
                checks.append(_check(
                    field, _gaps(P[field], R[field], per_frame=False), bound,
                    per_frame=False,
                    leaf=leaves[int(np.searchsorted(ends, worst,
                                                    side="right"))]))
            rn, pn = R["update_norm"], P["update_norm"]
            ratio = np.where(rn > 0, pn / np.where(rn > 0, rn, 1.0),
                             np.where(pn > 0, np.inf, 1.0))
            worst = int(np.argmax(np.abs(ratio - 1.0)))
            checks.append(_check("update_norm", [abs(ratio[worst] - 1.0)],
                                 NORM_RATIO_TOL, per_frame=False,
                                 leaf=leaves[worst],
                                 ratio_min=float(ratio.min()),
                                 ratio_max=float(ratio.max())))
        result["arms"][arm] = {"checks": checks, "steps": ps.tolist(),
                               "jax_steps": rs.tolist(),
                               "near_threshold": near,
                               "compared_frames": m, "split_at": split}
    return result


def failures(result: dict) -> list[str]:
    """``arm/field`` of every failed check."""
    return [f"{arm}/{c['field']}" for arm, a in result["arms"].items()
            for c in a["checks"] if not c["ok"]]


def report_lines(result: dict) -> list[str]:
    """One line per arm: each measured gap beside its bound (and where the
    reference's spread widened the allowance, from which frame, the
    largest allowance and the worst share of it); the gate arm's step
    counts and near-threshold frames."""
    lines = []
    for arm, a in result["arms"].items():
        parts = []
        for c in a["checks"]:
            if c["field"].startswith("recipe/") and c["ok"]:
                continue
            where = f" ({c['leaf']})" if c.get("leaf") else ""
            part = f"{c['field']}{where} {c['measured']:.3g}/{c['bound']:.3g}"
            if "widened_from" in c:
                share = ("inf" if c["share"] is None
                         else f"{c['share']:.3g}")
                part += (f" [x{SPREAD_FACTOR:g} ref spread from frame "
                         f"{c['widened_from']}: allowance up to "
                         f"{c['allowance']:.3g}, worst share {share}]")
            parts.append(part + ("" if c["ok"] else " FAILED"))
        line = (f"{arm}: frames compared {a['compared_frames']}; steps "
                f"{a['steps']}; " + ", ".join(parts))
        if ARMS[arm][1] >= 0:
            near = [(x["frame"], x["jax_steps"], x["port_steps"],
                     round(x["min_margin"], 8)) for x in a["near_threshold"]]
            line += (f"; jax steps {a['jax_steps']}; near-threshold frames "
                     f"(frame, jax, port, margin) {near}")
        lines.append(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--record", default=RECORD)
    ap.add_argument("--arms", nargs="+", default=list(ARMS),
                    choices=list(ARMS))
    args = ap.parse_args(argv)
    record = load_record(args.record)
    meta = record["meta"]
    run = run_all(args.device, meta["size"], meta["n_frames"], args.arms,
                  record["centers"])
    result = compare(record, run)
    for line in report_lines(result):
        print(line, file=sys.stderr)
    print(json.dumps({"ok": result["ok"], "failures": failures(result),
                      "seconds": {a: run["meta"]["arms"][a]["seconds"]
                                  for a in args.arms},
                      "arms": result["arms"]}))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
