"""Plain dynamic bilevel online adaptation of CLIFF, one frame per
``step``: ``step.py``'s algorithm (DynaBOA, arXiv 2111.04017, Algorithm 1)
with the network of ``cliff.py`` and CLIFF's full-frame camera.

It is its own copy of ``step.py``'s loss and step, for three reasons: the
network is CLIFF's and takes each row's box (the frame's, the history
slot's, the exemplar's); the state's history ring keeps its frames'
boxes; and the camera is not the crop's (``body.py``'s projection fixes
HMR's 224 crop and focal 5000).  The crop camera (s, tx, ty) of a box (cx,
cy, b) in a frame of w x h pixels becomes the full-frame translation

    (tx + 2 (cx - w/2) / (b s), ty + 2 (cy - h/2) / (b s), 2 f / (b s)),

f = sqrt(w^2 + h^2) (CLIFF's ``cam_crop2full``), a pinhole of focal f about
the frame's centre projects the joints, and the pixels are put back into
the box's [-1, 1] units, (x - c) / (b / 2), in which the stream's and the
exemplars' keypoints are.  Retrieval reads the pooled feature (tap 0) and
the gate the last fc2 output (tap 2 n_iter).  An empty history slot holds
the box of a square frame of the crop's size, (r/2, r/2, r, r, r), as the
system's does.  The exemplar draw is ``step.py``'s, which also takes each
exemplar's box; the decode, Adam with the teacher's EMA and the losses are
``step.py``'s, ``body.py``'s and ``losses.py``'s.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from perfbench.reference import body as B
from perfbench.reference import cliff
from perfbench.reference import losses as L
from perfbench.reference.step import State, _decode, adam_ema

RETRIEVAL_TAP = 0
BANK_KEYS = ("images", "keypoints", "pose", "betas", "pose_3d", "box")


@dataclass
class Context:
    """What the reference is given: the protocol's settings (the
    configuration file's ``adapt`` group), the network's ``model`` group and
    mean parameters, the bodies, the prior worked out by
    ``losses.gmm_prior``, and the retrieval store's raw arrays with a box
    per exemplar."""

    adapt: dict
    model: dict
    init: tuple            # (init_pose, init_shape, init_cam), each (1, n)
    bodies: dict
    Jh36m: torch.Tensor
    prior: dict
    store: dict | None
    compute_metrics: bool


@dataclass
class BoxState(State):
    hist_box: torch.Tensor = None    # (interval, 1, 5)


def empty_box(res: int, device) -> torch.Tensor:
    return torch.tensor([[res / 2, res / 2, res, res, res]], device=device)


def fresh_state(ctx: Context, params: dict, img_res: int, device) -> BoxState:
    from perfbench.reference.step import fresh_state as base

    st = base(ctx, params, img_res, device)
    return with_boxes(st, empty_box(img_res, device).repeat(
        ctx.adapt["interval"], 1, 1))


def with_boxes(st: State, hist_box: torch.Tensor) -> BoxState:
    """``st`` with the history ring's boxes ``hist_box``."""
    return BoxState(**{k: getattr(st, k) for k in State.__dataclass_fields__},
                    hist_box=hist_box)


def project(cam, s3d, box, eps=1e-9):
    """Full-frame projection in the box's [-1, 1] units (module docstring)."""
    cx, cy, b, w, h = (box[:, i] for i in range(5))
    f = torch.sqrt(w * w + h * h)
    bs = b * cam[:, 0] + eps
    t = torch.stack([cam[:, 1] + 2.0 * (cx - 0.5 * w) / bs,
                     cam[:, 2] + 2.0 * (cy - 0.5 * h) / bs, 2.0 * f / bs], 1)
    pts = s3d + t[:, None, :]
    px = f[:, None] * pts[..., 0] / pts[..., 2] + 0.5 * w[:, None]
    py = f[:, None] * pts[..., 1] / pts[..., 2] + 0.5 * h[:, None]
    half = 0.5 * b[:, None]
    return torch.stack([(px - cx[:, None]) / half,
                        (py - cy[:, None]) / half], -1)


def _forward(ctx, p, x, box):
    return cliff.forward(p, x, box, ctx.model, *ctx.init)


def _retrieve(ctx, feat, gen):
    s = ctx.store
    f = feat / torch.clamp(torch.linalg.vector_norm(feat), min=1e-12)
    c = s["centers"] / torch.clamp(torch.linalg.vector_norm(
        s["centers"], dim=1, keepdim=True), min=1e-12)
    cluster = torch.argmax(c @ f)
    mask = s["member_mask"][cluster]
    logits = torch.where(mask > 0, 0.0, -torch.inf)
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    pick = torch.topk(logits - torch.log(-torch.log(u)),
                      int(ctx.adapt["sample_num"])).indices
    idx = s["members"][cluster, pick]
    return {k: s[k][idx] for k in BANK_KEYS}


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
    rows, boxes = [frame["image"]], [frame["box"]]
    if use_motion:
        rows.append(st.hist_images[slot])
        boxes.append(st.hist_box[slot])
    if bank is not None:
        rows.append(bank["images"])
        boxes.append(bank["box"])
    x, box = torch.cat(rows, 0), torch.cat(boxes, 0)
    rotmat, shape, cam, taps = _forward(ctx, p, x, box)
    s3d, _ = _decode(ctx, rotmat, shape)
    s2d = project(cam, s3d, box)
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
            t_rot, t_shape, t_cam, _ = _forward(ctx, teacher, frame["image"],
                                                frame["box"])
            t_s3d, _ = _decode(ctx, t_rot, t_shape)
            t_s2d = project(t_cam, t_s3d, frame["box"])
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


def step(ctx: Context, st: BoxState, frame: dict, threshold: float,
         extra_cap: int) -> dict:
    """Adapt on one frame (``image (1, H, W, 3)``, ``box (1, 5)``, ``j2d
    (1, 49, 3)`` and, with metrics, ``pose``, ``betas``, ``gender``) and
    predict."""
    a = ctx.adapt
    R, G = RETRIEVAL_TAP, 2 * ctx.model["n_iter"]
    box = frame["box"]
    out = {}
    targets = None
    with torch.no_grad():
        if ctx.compute_metrics:
            targets = B.gt_targets(ctx.bodies, ctx.Jh36m, frame["pose"],
                                   frame["betas"], frame["gender"])
        init = _forward(ctx, st.params, frame["image"], box)
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
            bank = {k: ctx.store[k][:n] for k in BANK_KEYS}
        return bank if on else None

    bank = bank_for(init[3][R][0], "lower")
    ll, laux, g = _grad(ctx, st.params, frame, st, bank, "lower", st.teacher)
    learner = {k: st.params[k] - a["fastlr"] * g[k] for k in st.params}
    out["lower_loss"] = ll
    out.update({f"lower_{k}": v for k, v in laux.items()})
    if a["record_lowerlevel"]:
        with torch.no_grad():
            r, s, _, _ = _forward(ctx, learner, frame["image"], box)
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
            post = _forward(ctx, st.params, frame["image"], box)
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
        st.hist_box[slot] = box
    st.step += 1
    return out
