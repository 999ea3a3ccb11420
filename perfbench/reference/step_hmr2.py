"""Plain dynamic bilevel online adaptation of HMR 2.0, one frame per
``step``: ``step.py``'s algorithm (DynaBOA, arXiv 2111.04017, Algorithm 1)
with the network of ``hmr2.py``.

It is its own copy of ``step.py``'s loss and step, for two reasons: the
network is HMR 2.0's, and its weak-perspective camera projects into the
256-pixel crop (``body.py``'s projection fixes HMR's 224): a pinhole of
focal 5000 at depth 2 f / (256 s), normalised to [-1, 1] by 128, where
HMR 2.0's own loss divides by 256; the keypoints of the stream are in
DynaBOA's [-1, 1].  Retrieval reads the token mean (tap 1) where DynaBOA's
HMR reads its pooled ResNet feature, and the gate the cosine of the
decoder's output token (tap 2) where HMR's reads fc2's last output.  The
state, the exemplar draw, the decode, Adam with the teacher's EMA and the
losses are ``step.py``'s, ``body.py``'s and ``losses.py``'s.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from perfbench.reference import body as B
from perfbench.reference import hmr2
from perfbench.reference import losses as L
from perfbench.reference.step import _decode, _retrieve, adam_ema


@dataclass
class Context:
    """What the reference is given: the protocol's settings (the
    configuration file's ``adapt`` group), the network's ``model`` group and
    mean parameters, the bodies, the prior worked out by
    ``losses.gmm_prior``, and the retrieval store's raw arrays."""

    adapt: dict
    model: dict
    init: tuple            # (init_pose, init_shape, init_cam), each (1, n)
    bodies: dict
    Jh36m: torch.Tensor
    prior: dict
    store: dict | None
    compute_metrics: bool


def project_to_crop(cam, s3d, res, eps=1e-9):
    """Weak-perspective projection into the ``res`` crop, in [-1, 1]."""
    tz = 2.0 * B.FOCAL_LENGTH / (res * cam[:, 0] + eps)
    t = torch.stack([cam[:, 1], cam[:, 2], tz], -1)
    pts = s3d + t[:, None, :]
    return pts[..., :2] / pts[..., 2:3] * B.FOCAL_LENGTH / (res / 2.0)


def _forward(ctx, p, x):
    return hmr2.forward(p, x, ctx.model, *ctx.init)


def _project(ctx, cam, s3d):
    return project_to_crop(cam, s3d, ctx.model["img_res"])


def _level_loss(ctx, p, frame, st, bank, level, teacher):
    a = ctx.adapt
    up = level == "upper"
    use_frame = a["use_frame_losses_upper" if up else "use_frame_losses_lower"]
    temporal = a["use_temporal_losses_upper" if up
                 else "use_temporal_losses_lower"]
    use_motion = temporal and a["use_motion"]
    use_teacher = temporal and a["use_meanteacher"]
    joints = (slice(None, 25) if a["keypoint_source"] == "openpose"
              else slice(25, None))
    slot = st.step % a["interval"]
    rows = [frame["image"]]
    if use_motion:
        rows.append(st.hist_images[slot])
    if bank is not None:
        rows.append(bank["images"])
    x = torch.cat(rows, 0)
    rotmat, shape, cam, taps = _forward(ctx, p, x)
    s3d, _ = _decode(ctx, rotmat, shape)
    s2d = _project(ctx, cam, s3d)
    aux = {}
    loss = torch.zeros((), device=x.device)
    if use_frame:
        loss, parts = L.frame_loss(ctx.prior, s2d[:1], rotmat[:1], shape[:1],
                                   frame["j2d"], a, joints)
        aux.update(parts)
        aux["unlabelloss"] = loss
    if use_motion:
        ml = L.motion_loss(s2d[:1][:, joints], frame["j2d"][:, joints],
                           s2d[1:2][:, joints], st.hist_j2d[slot][:, joints])
        active = float(st.step > a["interval"])
        loss = loss + ml * active * a["motionloss_weight"]
        aux["motion_loss"] = ml * active
    if bank is not None:
        ex = slice(x.shape[0] - bank["images"].shape[0], x.shape[0])
        ll = L.labeled_loss(rotmat[ex], shape[ex], s2d[ex], s3d[ex],
                            bank["pose"], bank["betas"], bank["keypoints"],
                            bank["pose_3d"])
        loss = loss + ll * a["labelloss_weight"]
        aux["labledloss"] = ll
    if use_teacher:
        with torch.no_grad():
            t_rot, t_shape, t_cam, _ = _forward(ctx, teacher, frame["image"])
            t_s3d, _ = _decode(ctx, t_rot, t_shape)
            t_s2d = _project(ctx, t_cam, t_s3d)
        tl = L.teacher_loss(rotmat[:1], shape[:1], s2d[:1], s3d[:1], t_rot,
                            t_shape, t_s2d, t_s3d)
        loss = loss + tl * a["teacherloss_weight"]
        aux["teacherloss"] = tl
    return loss, taps, aux


def _grad(ctx, p, frame, st, bank, level, teacher=None):
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    loss, taps, aux = _level_loss(ctx, leaves, frame, st, bank, level, teacher)
    g = torch.autograd.grad(loss, list(leaves.values()))
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            dict(zip(p, g)))


def step(ctx: Context, st, frame: dict, threshold: float,
         extra_cap: int) -> dict:
    """Adapt on one frame (``image (1, H, W, 3)``, ``j2d (1, 49, 3)`` and,
    with metrics, ``pose``, ``betas``, ``gender``) and predict."""
    a = ctx.adapt
    R, G = hmr2.RETRIEVAL_TAP, hmr2.GATE_TAP
    out = {}
    targets = None
    with torch.no_grad():
        if ctx.compute_metrics:
            targets = B.gt_targets(ctx.bodies, ctx.Jh36m, frame["pose"],
                                   frame["betas"], frame["gender"])
        init = _forward(ctx, st.params, frame["image"])
    mixtrain = a["lower_level_mixtrain"] or a["upper_level_mixtrain"]

    def bank_for(feat, level):
        on = a["lower_level_mixtrain" if level == "lower"
               else "upper_level_mixtrain"]
        if not mixtrain:
            return None
        if a["retrieval"]:
            bank = _retrieve(ctx, feat, st.gen)
        else:
            n = int(a["sample_num"])
            bank = {k: ctx.store[k][:n] for k in ("images", "keypoints",
                                                  "pose", "betas", "pose_3d")}
        return bank if on else None

    bank = bank_for(init[3][R][0], "lower")
    ll, laux, g = _grad(ctx, st.params, frame, st, bank, "lower", st.teacher)
    learner = {k: st.params[k] - a["fastlr"] * g[k] for k in st.params}
    out["lower_loss"] = ll
    out.update({f"lower_{k}": v for k, v in laux.items()})
    if a["record_lowerlevel"]:
        with torch.no_grad():
            r, s, _, _ = _forward(ctx, learner, frame["image"])
            _, verts = _decode(ctx, r, s)
            if targets is not None:
                m = B.evaluate(ctx.Jh36m, verts, targets)
                out["lower_0_mpjpe"], out["lower_0_pampjpe"] = m[0], m[1]

    max_updates = 1 + (a["optim_steps"] if a["dynamic_boa"] else 0)
    pred, sim, n = init, None, 0
    losses, recs = [], []
    while n < max_updates and (
            n == 0 or (n <= extra_cap and bool((1.0 - sim) > threshold))):
        bank = bank_for(pred[3][R][0], "upper")
        ul, uaux, g = _grad(ctx, learner if n == 0 else st.params, frame, st,
                            bank, "upper", st.teacher)
        losses.append(ul)
        if n == 0:
            out["grad_norms"] = {k: torch.linalg.vector_norm(x)
                                 for k, x in g.items()}
            out["upper_loss"] = ul
            out.update({f"upper_{k}": v for k, v in uaux.items()})
        adam_ema(ctx, st, g)
        with torch.no_grad():
            post = _forward(ctx, st.params, frame["image"])
            sim = L.cosine(pred[3][G], post[3][G])
            if a["record_dynamic"] and targets is not None:
                _, verts = _decode(ctx, post[0], post[1])
                recs.append(torch.stack(B.evaluate(ctx.Jh36m, verts,
                                                   targets)))
        pred = post
        n += 1
    out["n_updates"] = n
    out["per_step_loss"] = torch.stack(losses)
    if recs:
        out["per_step_metrics"] = torch.stack(recs)     # (n, 3, 1)
    with torch.no_grad():
        _, verts = _decode(ctx, pred[0], pred[1])
        if targets is not None:
            out["mpjpe"], out["pampjpe"], out["pve"] = B.evaluate(
                ctx.Jh36m, verts, targets)
        out.update(verts=verts, rotmat=pred[0], beta=pred[1], cam=pred[2])
        slot = st.step % a["interval"]
        st.hist_images[slot] = frame["image"]
        st.hist_j2d[slot] = frame["j2d"]
    st.step += 1
    return out
