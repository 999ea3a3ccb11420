"""SMPLify: iterative test-time body fitting on torch tensors (counterpart
of ``dynaboa_tpu/smplify.py``).

Two stages of Adam: stage 1 fits the camera translation and the global
orientation against the hip and shoulder reprojection with a depth anchor;
stage 2 fits the body pose, betas and global orientation against the
Geman-McClure robust reprojection error with the GMM, angle and shape
priors.  Each stage is a Python loop of ``torch.optim.Adam`` steps with
fresh optimizer state; gradients flow through the eager SMPL forward (the
skinning kernel has no backward pass).
"""

from __future__ import annotations

import torch

from dynaboa_tpu_torch import constants
from dynaboa_tpu_torch.losses.priors import (GMMPrior, angle_prior,
                                             gmm_prior_nll)
from dynaboa_tpu_torch.models.smpl import SMPLModel, smpl_forward
from dynaboa_tpu_torch.ops.camera import perspective_projection


def gmof(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Geman-McClure robust error."""
    x2 = x ** 2
    s2 = sigma ** 2
    return (s2 * x2) / (s2 + x2)


# joint groups: the stage-1 anchors (OpenPose and ground-truth hips and
# shoulders) and the joints stage 2 ignores
_OP_ANCHORS = [constants.JOINT_IDS[j] for j in
               ("OP RHip", "OP LHip", "OP RShoulder", "OP LShoulder")]
_GT_ANCHORS = [constants.JOINT_IDS[j] for j in
               ("Right Hip", "Left Hip", "Right Shoulder", "Left Shoulder")]
IGNORED_JOINTS = [constants.JOINT_IDS[j] for j in
                  ("OP Neck", "OP RHip", "OP LHip", "Right Hip", "Left Hip")]


def _project(joints, cam_t, camera_center, focal_length):
    B = joints.shape[0]
    eye = torch.eye(3, dtype=joints.dtype, device=joints.device).expand(
        B, 3, 3)
    return perspective_projection(joints, eye, cam_t, focal_length,
                                  camera_center)


def camera_fitting_loss(model_joints, camera_t, camera_t_est, camera_center,
                        joints_2d, joints_conf, focal_length=5000.0,
                        depth_loss_weight=100.0):
    """Stage-1 loss, a scalar: the OpenPose anchors' reprojection where all
    four are confident, else the ground-truth anchors', plus the depth
    anchor to the initial translation."""
    proj = _project(model_joints, camera_t, camera_center, focal_length)
    err_op = (joints_2d[:, _OP_ANCHORS] - proj[:, _OP_ANCHORS]) ** 2
    err_gt = (joints_2d[:, _GT_ANCHORS] - proj[:, _GT_ANCHORS]) ** 2
    is_valid = (joints_conf[:, _OP_ANCHORS].min(dim=-1).values > 0).to(
        joints_2d.dtype)[:, None, None]
    reproj = (is_valid * err_op + (1 - is_valid) * err_gt).sum(dim=(1, 2))
    depth = (depth_loss_weight ** 2) * (camera_t[:, 2]
                                        - camera_t_est[:, 2]) ** 2
    return (reproj + depth).sum()


def body_fitting_loss(body_pose, betas, model_joints, camera_t, camera_center,
                      joints_2d, joints_conf, prior: GMMPrior,
                      focal_length=5000.0, sigma=100.0,
                      pose_prior_weight=4.78, shape_prior_weight=5.0,
                      angle_prior_weight=15.2, output="sum"):
    """Stage-2 loss: a scalar, or with ``output="reprojection"`` the
    (B, J) per-joint reprojection term."""
    proj = _project(model_joints, camera_t, camera_center, focal_length)
    reproj_err = gmof(proj - joints_2d, sigma)
    reproj = (joints_conf ** 2) * reproj_err.sum(dim=-1)
    if output == "reprojection":
        return reproj

    pose_prior_loss = (pose_prior_weight ** 2) * gmm_prior_nll(prior,
                                                               body_pose)
    angle_loss = (angle_prior_weight ** 2) * angle_prior(body_pose).sum(
        dim=-1)
    shape_loss = (shape_prior_weight ** 2) * (betas ** 2).sum(dim=-1)
    total = reproj.sum(dim=-1) + pose_prior_loss + angle_loss + shape_loss
    return total.sum()


def body_fitting_loss_smplify_x(body_pose, betas, pose_embedding, camera_t,
                                camera_center, model_joints, joints_conf,
                                joints_2d, focal_length=5000.0, sigma=100.0,
                                body_pose_weight=4.78, shape_prior_weight=5.0,
                                angle_prior_weight=15.2, output="sum"):
    """The SMPLify-X variant of ``body_fitting_loss``: the GMM pose prior
    is replaced by ``body_pose_weight**2 * sum(pose_embedding**2)`` over a
    (B, Z) latent pose code."""
    proj = _project(model_joints, camera_t, camera_center, focal_length)
    reproj_err = gmof(proj - joints_2d, sigma)
    reproj = (joints_conf ** 2) * reproj_err.sum(dim=-1)
    if output == "reprojection":
        return reproj

    pose_prior_loss = (body_pose_weight ** 2) * torch.sum(pose_embedding ** 2)
    shape_loss = (shape_prior_weight ** 2) * (betas ** 2).sum(dim=-1)
    angle_loss = (angle_prior_weight ** 2) * angle_prior(body_pose).sum(
        dim=-1)
    total = reproj.sum(dim=-1) + pose_prior_loss + angle_loss + shape_loss
    return total.sum()


class SMPLify:
    """Two-stage SMPL fitting on the device of the SMPL model's tensors."""

    def __init__(self, smpl: SMPLModel, prior: GMMPrior,
                 step_size: float = 1e-2, num_iters: int = 100,
                 focal_length: float = 5000.0):
        self.smpl = smpl
        self.prior = prior
        self.step_size = step_size
        self.num_iters = num_iters
        self.focal_length = focal_length
        self.device = smpl.v_template.device

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _joints(self, global_orient, body_pose, betas):
        pose = torch.cat([global_orient, body_pose], dim=1)
        out = smpl_forward(self.smpl, betas, pose, pose2rot=True)
        return out.joints, out.vertices

    def _run_stage(self, loss_fn, params: dict, n_iters: int) -> dict:
        """``n_iters`` Adam steps from fresh optimizer state (optax's adam
        with eps_root 0 is the same update)."""
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params.items()}
        opt = torch.optim.Adam(list(params.values()), lr=self.step_size,
                               betas=(0.9, 0.999), eps=1e-8)
        for _ in range(n_iters):
            opt.zero_grad(set_to_none=True)
            loss_fn(params).backward()
            opt.step()
        return {k: v.detach() for k, v in params.items()}

    def _ignore_joints(self, conf: torch.Tensor) -> torch.Tensor:
        conf = conf.clone()
        conf[:, IGNORED_JOINTS] = 0.0
        return conf

    def __call__(self, init_pose, init_betas, init_cam_t, camera_center,
                 keypoints_2d):
        """Fit the body model to 2D keypoints.

        Args:
          init_pose: (B, 72), init_betas: (B, 10), init_cam_t: (B, 3),
          camera_center: (B, 2), keypoints_2d: (B, 49, 3).
        Returns:
          (vertices, joints, pose, betas, camera_translation,
           per-joint reprojection loss)
        """
        init_pose, init_betas, init_cam_t, camera_center, keypoints_2d = (
            self._tensor(a) for a in (init_pose, init_betas, init_cam_t,
                                      camera_center, keypoints_2d))
        joints_2d = keypoints_2d[..., :2]
        joints_conf = keypoints_2d[..., 2]
        body_pose0 = init_pose[:, 3:]
        global_orient0 = init_pose[:, :3]

        # stage 1: camera translation + global orient
        def cam_loss(p):
            joints, _ = self._joints(p["global_orient"], body_pose0,
                                     init_betas)
            return camera_fitting_loss(
                joints, p["camera_t"], init_cam_t, camera_center,
                joints_2d, joints_conf, self.focal_length)

        p1 = self._run_stage(
            cam_loss, {"global_orient": global_orient0,
                       "camera_t": init_cam_t}, self.num_iters)
        camera_t = p1["camera_t"]

        # stage 2: body pose + betas + global orient; hip/neck joints ignored
        conf2 = self._ignore_joints(joints_conf)

        def body_loss(p):
            joints, _ = self._joints(p["global_orient"], p["body_pose"],
                                     p["betas"])
            return body_fitting_loss(
                p["body_pose"], p["betas"], joints, camera_t, camera_center,
                joints_2d, conf2, self.prior, self.focal_length)

        p2 = self._run_stage(
            body_loss, {"global_orient": p1["global_orient"],
                        "body_pose": body_pose0, "betas": init_betas},
            self.num_iters)

        with torch.no_grad():
            joints, vertices = self._joints(p2["global_orient"],
                                            p2["body_pose"], p2["betas"])
            reproj = body_fitting_loss(
                p2["body_pose"], p2["betas"], joints, camera_t,
                camera_center, joints_2d, conf2, self.prior,
                self.focal_length, output="reprojection")
        pose = torch.cat([p2["global_orient"], p2["body_pose"]], dim=1)
        return vertices, joints, pose, p2["betas"], camera_t, reproj

    def get_fitting_loss(self, pose, betas, cam_t, camera_center,
                         keypoints_2d):
        """The (B, 49) per-joint reprojection loss at the given
        parameters."""
        pose, betas, cam_t, camera_center, keypoints_2d = (
            self._tensor(a) for a in (pose, betas, cam_t, camera_center,
                                      keypoints_2d))
        conf = self._ignore_joints(keypoints_2d[..., 2])
        with torch.no_grad():
            joints, _ = self._joints(pose[:, :3], pose[:, 3:], betas)
            return body_fitting_loss(pose[:, 3:], betas, joints, cam_t,
                                     camera_center, keypoints_2d[..., :2],
                                     conf, self.prior, self.focal_length,
                                     output="reprojection")
