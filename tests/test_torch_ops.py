"""Geometry ops of the port against ``dynaboa_tpu.ops`` on the same random
inputs, including the branch cases of tests/test_rotations.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dynaboa_tpu.ops import camera as jcam
from dynaboa_tpu.ops import procrustes as jpro
from dynaboa_tpu.ops import rotations as jrot
from dynaboa_tpu_torch.ops import camera as tcam
from dynaboa_tpu_torch.ops import procrustes as tpro
from dynaboa_tpu_torch.ops import rotations as trot
from tests.test_rotations import random_rotmats

ATOL = 1e-5   # fp32, same formulas; XLA and torch may fuse differently


def both(fn_j, fn_t, *arrays):
    j = np.asarray(fn_j(*[jnp.asarray(a) for a in arrays]))
    t = fn_t(*[torch.as_tensor(a) for a in arrays]).numpy()
    return j, t


def near_pi_rotmats(rng, n):
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    aa = (axis * (np.pi - 1e-3)).astype(np.float32)
    return np.array(jrot.batch_rodrigues(jnp.asarray(aa)))


def test_rot6d_to_rotmat(rng):
    x = rng.normal(size=(4, 24 * 6)).astype(np.float32)
    j, t = both(jrot.rot6d_to_rotmat, trot.rot6d_to_rotmat, x)
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_rot6d_degenerate_uses_same_eps():
    # a zero column hits the max(||v||, eps) clamp on both sides
    x = np.zeros((2, 6), np.float32)
    x[1, 0] = 1.0
    j, t = both(jrot.rot6d_to_rotmat, trot.rot6d_to_rotmat, x)
    np.testing.assert_array_equal(t, j)


def test_batch_rodrigues_including_zero(rng):
    aa = rng.normal(size=(16, 3)).astype(np.float32)
    aa[0] = 0.0
    j, t = both(jrot.batch_rodrigues, trot.batch_rodrigues, aa)
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_quat_to_rotmat(rng):
    q = rng.normal(size=(16, 4)).astype(np.float32)
    j, t = both(jrot.quat_to_rotmat, trot.quat_to_rotmat, q)
    np.testing.assert_allclose(t, j, atol=ATOL)


@pytest.mark.parametrize("case", ["random", "near_pi", "identity",
                                  "half_turns"])
def test_rotmat_to_quat_and_aa_branches(rng, case):
    if case == "random":
        R = random_rotmats(rng, 64)
    elif case == "near_pi":         # the w ~ 0 branches
        R = near_pi_rotmats(rng, 16)
    elif case == "identity":        # the small-angle fallback of quat_to_aa
        R = np.broadcast_to(np.eye(3, dtype=np.float32), (2, 3, 3)).copy()
    else:                           # exact half turns about each axis
        R = np.stack([np.diag(d).astype(np.float32) for d in
                      ([1, -1, -1], [-1, 1, -1], [-1, -1, 1])])
    jq, tq = both(jrot.rotmat_to_quat, trot.rotmat_to_quat, R)
    np.testing.assert_allclose(tq, jq, atol=ATOL)
    ja, ta = both(jrot.rotmat_to_aa, trot.rotmat_to_aa, R)
    np.testing.assert_allclose(ta, ja, atol=1e-4)


def test_quat_to_aa_negative_w(rng):
    q = rng.normal(size=(32, 4)).astype(np.float32)
    q[:16, 0] = -np.abs(q[:16, 0])
    j, t = both(jrot.quat_to_aa, trot.quat_to_aa, q)
    np.testing.assert_allclose(t, j, atol=1e-4)


def test_rotmat_to_aa_grad_finite_at_identity():
    R = torch.eye(3).expand(2, 3, 3).clone().requires_grad_()
    trot.rotmat_to_aa(R).sum().backward()
    assert torch.isfinite(R.grad).all()


def test_perspective_projection(rng):
    pts = rng.normal(size=(2, 10, 3)).astype(np.float32)
    pts[..., 2] += 10.0
    R = random_rotmats(rng, 2)
    t = rng.normal(size=(2, 3)).astype(np.float32)
    c = rng.normal(size=(2, 2)).astype(np.float32)
    jo = jcam.perspective_projection(jnp.asarray(pts), jnp.asarray(R),
                                     jnp.asarray(t), 5000.0, jnp.asarray(c))
    to = tcam.perspective_projection(torch.as_tensor(pts), torch.as_tensor(R),
                                     torch.as_tensor(t), 5000.0,
                                     torch.as_tensor(c))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-3)


def test_project_to_crop_and_translation(rng):
    cam = np.concatenate([rng.uniform(0.5, 1.2, size=(3, 1)),
                          rng.normal(size=(3, 2))], -1).astype(np.float32)
    s3d = rng.normal(size=(3, 49, 3)).astype(np.float32)
    j, t = both(jcam.weak_perspective_to_translation,
                tcam.weak_perspective_to_translation, cam)
    np.testing.assert_allclose(t, j, rtol=1e-6)
    jo = jcam.project_to_crop(jnp.asarray(cam), jnp.asarray(s3d))
    to = tcam.project_to_crop(torch.as_tensor(cam), torch.as_tensor(s3d))
    for k in ("ori", "normed"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                   rtol=1e-5, atol=1e-4)


def test_similarity_transform_and_error(rng):
    S1 = rng.normal(size=(4, 14, 3)).astype(np.float32)
    S2 = rng.normal(size=(4, 14, 3)).astype(np.float32)
    j, t = both(jpro.similarity_transform, tpro.similarity_transform, S1, S2)
    np.testing.assert_allclose(t, j, atol=1e-5)
    j, t = both(jpro.reconstruction_error, tpro.reconstruction_error, S1, S2)
    np.testing.assert_allclose(t, j, rtol=1e-5)


def test_similarity_transform_reflection_case(rng):
    # a mirrored target forces the det < 0 correction
    S1 = rng.normal(size=(2, 14, 3)).astype(np.float32)
    S2 = S1 * np.array([1.0, 1.0, -1.0], np.float32)
    j, t = both(jpro.similarity_transform, tpro.similarity_transform, S1, S2)
    np.testing.assert_allclose(t, j, atol=1e-5)
