"""Plain dynamic bilevel online adaptation, one frame per ``step``
(DynaBOA, arXiv 2111.04017, Algorithm 1; the reference code's
``dynaboa_benchmark.py`` and ``dynaboa_webcam.py`` protocols).

Per frame:

1. a no-grad forward gives the frame's initial taps;
2. one lower-level step: the gradient of the lower loss (frame terms, plus
   the labeled loss of one retrieved exemplar where mixtrain is on) at the
   current weights, and a plain SGD step of ``fastlr`` on a copy of them;
3. upper-level updates: update 0 takes the upper loss's gradient at the
   lower-adapted copy, each later one at the current weights; each gradient
   goes through Adam into the weights, then the teacher moves to
   ``alpha * teacher + (1 - alpha) * weights`` and a forward of the new
   weights gives the gate's signal, ``1 - cos`` of tap 12 against the
   previous forward's; another update follows while that exceeds the
   threshold, at most ``extra_cap`` extra ones;
4. the last forward, decoded through SMPL, is the prediction, with MPJPE,
   PA-MPJPE and PVE where the stream has ground truth;
5. the frame and its keypoints go into the motion-history ring.

The upper loss adds the motion term (against the frame ``interval`` frames
back, active once the stream is that long) and the mean-teacher term.
Exemplars are drawn by the nearest K-means centre to tap 5 (cosine) and a
uniform draw within its cluster (Gumbel top-1), from a generator carried in
the state.  Adam is written out here: ``m, v`` moments, bias-corrected.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from perfbench.reference import body as B
from perfbench.reference import hmr
from perfbench.reference import losses as L


@dataclass
class Context:
    """What the reference is given: the protocol's settings (the
    configuration file's ``adapt`` group), the network's depths and mean
    parameters, the bodies, the prior's raw arrays worked out by
    ``losses.gmm_prior``, and the retrieval store's raw arrays."""

    adapt: dict
    layers: tuple
    n_iter: int
    init: tuple            # (init_pose, init_shape, init_cam), each (1, n)
    bodies: dict           # neutral / male / female -> body dict
    Jh36m: torch.Tensor
    prior: dict
    store: dict | None     # centers, members, member_mask and the bank
    compute_metrics: bool


@dataclass
class State:
    params: dict
    teacher: dict
    m: dict
    v: dict
    t: float               # Adam's step count
    hist_images: torch.Tensor
    hist_j2d: torch.Tensor
    step: int
    gen: torch.Generator


def fresh_state(ctx: Context, params: dict, img_res: int, device) -> State:
    a = ctx.adapt
    gen = torch.Generator(device=device)
    gen.manual_seed(int(a["seed"]))
    return State(
        params={k: v.detach().clone() for k, v in params.items()},
        teacher={k: v.detach().clone() for k, v in params.items()},
        m={k: torch.zeros_like(v) for k, v in params.items()},
        v={k: torch.zeros_like(v) for k, v in params.items()},
        t=0.0,
        hist_images=torch.zeros((a["interval"], 1, img_res, img_res, 3),
                                device=device),
        hist_j2d=torch.zeros((a["interval"], 1, 49, 3), device=device),
        step=0, gen=gen)


def _forward(ctx, p, x):
    return hmr.forward(p, x, ctx.layers, ctx.n_iter, *ctx.init)


def _decode(ctx, rotmat, shape):
    """-> (49 joints, vertices)."""
    verts, joints = B.smpl(ctx.bodies["neutral"], shape, rotmat)
    return joints, verts


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
    return {k: s[k][idx] for k in ("images", "keypoints", "pose", "betas",
                                   "pose_3d")}


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
    s2d = B.project_to_crop(cam, s3d)
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
            t_s2d = B.project_to_crop(t_cam, t_s3d)
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


def adam_ema(ctx, st, grads):
    """Adam with bias correction into ``st.params``, then the teacher."""
    a = ctx.adapt
    b1, b2, lr = a["beta1"], a["beta2"], a["lr"]
    st.t += 1.0
    c1, c2 = 1.0 - b1 ** st.t, 1.0 - b2 ** st.t
    alpha = a["alpha"]
    for k, g in grads.items():
        st.m[k] = b1 * st.m[k] + (1.0 - b1) * g
        st.v[k] = b2 * st.v[k] + (1.0 - b2) * g * g
        step = lr * (st.m[k] / c1) / (torch.sqrt(st.v[k] / c2) + 1e-8)
        st.params[k] = st.params[k] - step
        st.teacher[k] = alpha * st.teacher[k] + (1.0 - alpha) * st.params[k]


def step(ctx: Context, st: State, frame: dict, threshold: float,
         extra_cap: int) -> dict:
    """Adapt on one frame (``image (1, H, W, 3)``, ``j2d (1, 49, 3)`` and,
    with metrics, ``pose``, ``betas``, ``gender``) and predict."""
    a = ctx.adapt
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

    bank = bank_for(init[3][5][0], "lower")
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
        bank = bank_for(pred[3][5][0], "upper")
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
            sim = L.cosine(pred[3][12], post[3][12])
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
