"""SMPLify of the port against the JAX package's: the robust error, the
four losses and their gradients, and the two-stage fit after 1 and after
30 Adam iterations per stage, on the same numpy bodies and keypoints."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dynaboa_tpu import smplify as js
from dynaboa_tpu.losses import synthetic_gmm_prior as j_prior
from dynaboa_tpu.models import smpl_forward as j_smpl_forward
from dynaboa_tpu.models import synthetic_smpl_model as j_smpl
from dynaboa_tpu.ops.camera import perspective_projection as j_project
from dynaboa_tpu_torch import smplify as ts
from dynaboa_tpu_torch.losses.priors import synthetic_gmm_prior as t_prior
from dynaboa_tpu_torch.models.smpl import synthetic_smpl_model as t_smpl
from tests import torch_port_fixtures as F

B = 2
LR = 1e-2                 # SMPLify's default step size
# float32 losses; measured: the values bit-equal, the gradients' worst
# relative gap 2.7e-5 on a small entry (1.4e-7 of the array's largest)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# 1 iteration per stage: measured worst gap 1.5e-7 (pose), 6.7e-8 (betas,
# camera); no coordinate had a JAX gradient at rounding level
ONE_STEP_ATOL = 1e-4
# 30 iterations per stage: measured worst gap 1.1e-5 (betas) against the
# drift bound num_iters * lr = 0.3 (docs/PARITY.md); the final reprojection
# sums 5131.77 against JAX's 5131.80 (6e-6 relative)
REPROJ_RTOL = 5e-2


@pytest.fixture(scope="module")
def bodies():
    return (j_smpl(seed=20, num_vertices=F.NV), j_prior(seed=21),
            t_smpl(20, F.CPU, num_vertices=F.NV), t_prior(21, F.CPU))


@pytest.fixture(scope="module")
def targets(bodies):
    """Keypoints projected from known bodies and a perturbed initial pose
    (the recipe of tests/test_smplify_iso.py)."""
    jsmpl = bodies[0]
    rng = np.random.default_rng(0)
    gt_pose = rng.normal(scale=0.15, size=(B, 72)).astype(np.float32)
    gt_betas = rng.normal(scale=0.3, size=(B, 10)).astype(np.float32)
    cam_t = np.tile([0.0, 0.0, 10.0], (B, 1)).astype(np.float32)
    center = np.full((B, 2), 112.0, np.float32)
    out = jax.jit(lambda b, p: j_smpl_forward(jsmpl, b, p, pose2rot=True))(
        jnp.asarray(gt_betas), jnp.asarray(gt_pose))
    j2d = np.asarray(j_project(out.joints, jnp.broadcast_to(jnp.eye(3),
                                                            (B, 3, 3)),
                               jnp.asarray(cam_t), 5000.0,
                               jnp.asarray(center)))
    kp = np.concatenate([j2d, np.ones((B, 49, 1))], -1).astype(np.float32)
    init_pose = (gt_pose + 0.2 * rng.normal(size=(B, 72))).astype(np.float32)
    return dict(init_pose=init_pose, init_betas=np.zeros((B, 10), np.float32),
                cam_t=cam_t, center=center, kp=kp)


def _loss_inputs(seed=1):
    rng = np.random.default_rng(seed)
    conf = rng.uniform(0.0, 1.0, size=(B, 49)).astype(np.float32)
    conf[0, ts._OP_ANCHORS[0]] = 0.0          # sample 0: the GT anchors
    return dict(
        model_joints=rng.normal(scale=0.5, size=(B, 49, 3)).astype(np.float32),
        camera_t=np.array([[0.1, -0.1, 9.5], [0.0, 0.2, 10.5]], np.float32),
        camera_t_est=np.tile([0.0, 0.0, 10.0], (B, 1)).astype(np.float32),
        camera_center=np.full((B, 2), 112.0, np.float32),
        joints_2d=rng.uniform(0, 224, size=(B, 49, 2)).astype(np.float32),
        joints_conf=conf,
        body_pose=rng.normal(scale=0.3, size=(B, 69)).astype(np.float32),
        betas=rng.normal(scale=0.5, size=(B, 10)).astype(np.float32),
        pose_embedding=rng.normal(size=(B, 32)).astype(np.float32))


def _call(mod, name, prior, a, wrap, **kw):
    """One loss of ``mod`` (js or ts) on the inputs ``a`` mapped by
    ``wrap``."""
    x = {k: wrap(v) for k, v in a.items()}
    if name == "camera":
        return mod.camera_fitting_loss(
            x["model_joints"], x["camera_t"], x["camera_t_est"],
            x["camera_center"], x["joints_2d"], x["joints_conf"])
    if name == "body":
        return mod.body_fitting_loss(
            x["body_pose"], x["betas"], x["model_joints"], x["camera_t"],
            x["camera_center"], x["joints_2d"], x["joints_conf"], prior, **kw)
    return mod.body_fitting_loss_smplify_x(
        x["body_pose"], x["betas"], x["pose_embedding"], x["camera_t"],
        x["camera_center"], x["model_joints"], x["joints_conf"],
        x["joints_2d"], **kw)


def test_gmof_matches_jax():
    x = np.random.default_rng(2).normal(scale=200.0, size=(4, 49, 2)).astype(
        np.float32)
    np.testing.assert_allclose(ts.gmof(torch.as_tensor(x), 100.0).numpy(),
                               np.asarray(js.gmof(jnp.asarray(x), 100.0)),
                               rtol=LOSS_RTOL)


def test_joint_tables_equal_jax():
    assert ts._OP_ANCHORS == js._OP_ANCHORS
    assert ts._GT_ANCHORS == js._GT_ANCHORS
    assert ts.IGNORED_JOINTS == js.IGNORED_JOINTS


@pytest.mark.parametrize("name,output", [
    ("camera", "sum"), ("body", "sum"), ("body", "reprojection"),
    ("smplify_x", "sum"), ("smplify_x", "reprojection")])
def test_losses_match_jax(bodies, name, output):
    _, jprior, _, tprior = bodies
    a = _loss_inputs()
    kw = {} if name == "camera" else {"output": output}
    want = np.asarray(_call(js, name, jprior, a, jnp.asarray, **kw))
    got = _call(ts, name, tprior, a, torch.as_tensor, **kw).numpy()
    assert got.shape == want.shape == (() if output == "sum" else (B, 49))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("name,wrt", [
    ("camera", ("model_joints", "camera_t")),
    ("body", ("body_pose", "betas", "model_joints")),
    ("smplify_x", ("body_pose", "betas", "pose_embedding", "model_joints"))])
def test_loss_gradients_match_jax_grad(bodies, name, wrt):
    _, jprior, _, tprior = bodies
    a = _loss_inputs(seed=3)

    def jloss(sub):
        return _call(js, name, jprior, {**a, **sub}, jnp.asarray)

    jg = jax.grad(jloss)({k: jnp.asarray(a[k]) for k in wrt})
    leaves = {k: torch.as_tensor(a[k]).requires_grad_(True) for k in wrt}
    _call(ts, name, tprior, {**a, **leaves},
          lambda v: v if isinstance(v, torch.Tensor)
          else torch.as_tensor(v)).backward()
    for k in wrt:
        want = np.asarray(jg[k])
        np.testing.assert_allclose(leaves[k].grad.numpy(), want,
                                   rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(want).max(),
                                   err_msg=k)


def _fit_both(bodies, targets, num_iters):
    jsmpl, jprior, tsmpl, tprior = bodies
    args = [targets[k] for k in ("init_pose", "init_betas", "cam_t",
                                 "center", "kp")]
    jfit = js.SMPLify(jsmpl, jprior, num_iters=num_iters)
    tfit = ts.SMPLify(tsmpl, tprior, num_iters=num_iters)
    jout = [np.asarray(o) for o in jfit(*map(jnp.asarray, args))]
    tout = tfit(*args)
    assert all(o.device == F.CPU and torch.isfinite(o).all() for o in tout)
    return jfit, tfit, jout, [o.numpy() for o in tout], args


def _rounding_level(g):
    """Coordinates whose gradient is at rounding level within its array."""
    g = np.asarray(g)
    return np.abs(g) <= 1e-5 * np.abs(g).max()


def _jax_stage_grads(jfit, targets):
    """JAX's gradients at the start of each stage of a 1-iteration fit:
    stage 1 at the initial parameters, stage 2 after Adam's first step
    (p - lr * g / (|g| + eps)) of stage 1."""
    pose0 = jnp.asarray(targets["init_pose"])
    betas0 = jnp.asarray(targets["init_betas"])
    cam0 = jnp.asarray(targets["cam_t"])
    center = jnp.asarray(targets["center"])
    kp = jnp.asarray(targets["kp"])
    j2d, conf = kp[..., :2], kp[..., 2]

    def cam_loss(p):
        joints, _ = jfit._joints(p["global_orient"], pose0[:, 3:], betas0)
        return js.camera_fitting_loss(joints, p["camera_t"], cam0, center,
                                      j2d, conf)

    p1 = {"global_orient": pose0[:, :3], "camera_t": cam0}
    g1 = jax.jit(jax.grad(cam_loss))(p1)
    p1 = {k: v - LR * g1[k] / (jnp.abs(g1[k]) + 1e-8) for k, v in p1.items()}
    conf2 = conf.at[:, jnp.asarray(js.IGNORED_JOINTS)].set(0.0)

    def body_loss(p):
        joints, _ = jfit._joints(p["global_orient"], p["body_pose"],
                                 p["betas"])
        return js.body_fitting_loss(p["body_pose"], p["betas"], joints,
                                    p1["camera_t"], center, j2d, conf2,
                                    jfit.prior)

    g2 = jax.jit(jax.grad(body_loss))({"global_orient": p1["global_orient"],
                              "body_pose": pose0[:, 3:], "betas": betas0})
    return g1, g2


def test_one_iteration_fit_matches_jax(bodies, targets):
    """Adam's first step is about lr * sign(g) on every coordinate, so a
    coordinate whose gradient sits at rounding level may step either way:
    such a coordinate is reported and each package's move bounded by lr;
    every other coordinate agrees within 1e-4."""
    jfit, _, jout, tout, _ = _fit_both(bodies, targets, 1)
    g1, g2 = _jax_stage_grads(jfit, targets)
    start = {"pose": targets["init_pose"], "betas": targets["init_betas"],
             "camera_t": targets["cam_t"]}
    rounding = {
        # global_orient steps in both stages, the body pose in stage 2
        "pose": np.concatenate([_rounding_level(g1["global_orient"])
                                | _rounding_level(g2["global_orient"]),
                                _rounding_level(g2["body_pose"])], axis=1),
        "betas": _rounding_level(g2["betas"]),
        "camera_t": _rounding_level(g1["camera_t"])}
    for i, name in ((2, "pose"), (3, "betas"), (4, "camera_t")):
        gap = np.abs(tout[i] - jout[i])
        far = gap > ONE_STEP_ATOL
        flagged = np.argwhere(far & rounding[name]).tolist()
        if flagged:
            print(f"{name}: coordinates at rounding level {flagged}")
        assert not (far & ~rounding[name]).any(), (name, gap.max())
        steps = 2 if name == "pose" else 1
        for out in (tout[i], jout[i]):
            move = np.abs(out - start[name])[rounding[name]]
            assert (move <= steps * LR * (1 + 1e-4)).all(), name
    np.testing.assert_allclose(tout[5], jout[5], rtol=LOSS_RTOL, atol=1e-2)


def test_thirty_iteration_fit_matches_jax(bodies, targets):
    n = 30
    jfit, tfit, jout, tout, args = _fit_both(bodies, targets, n)
    bound = n * LR
    # the global orientation takes 2 * n steps (both stages)
    np.testing.assert_allclose(tout[2][:, :3], jout[2][:, :3], rtol=0,
                               atol=2 * bound)
    np.testing.assert_allclose(tout[2][:, 3:], jout[2][:, 3:], rtol=0,
                               atol=bound)
    np.testing.assert_allclose(tout[3], jout[3], rtol=0, atol=bound)
    np.testing.assert_allclose(tout[4], jout[4], rtol=0, atol=bound)
    assert tout[0].shape == (B, F.NV, 3) and tout[1].shape == (B, 49, 3)
    np.testing.assert_allclose(tout[5].sum(), jout[5].sum(),
                               rtol=REPROJ_RTOL)
    before_t = float(tfit.get_fitting_loss(*args[:3], *args[3:]).sum())
    before_j = float(np.asarray(jfit.get_fitting_loss(
        *map(jnp.asarray, args))).sum())
    np.testing.assert_allclose(before_t, before_j, rtol=LOSS_RTOL)
    assert tout[5].sum() < before_t and jout[5].sum() < before_j
