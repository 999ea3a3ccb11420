"""The priors' tail (full GMM NLL, mixture mean, angle and L2 priors,
``create_prior``), the translation fit and ``original_joints`` of the port
against the JAX package's, on the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dynaboa_tpu.losses import priors as jp
from dynaboa_tpu.models import smpl as jsmpl
from dynaboa_tpu.ops import camera as jcam
from dynaboa_tpu_torch.losses import priors as tp
from dynaboa_tpu_torch.models import smpl as tsmpl
from dynaboa_tpu_torch.ops import camera as tcam
from tests import torch_port_fixtures as F

# float32 with another summation order over 69 x 69 terms; measured worst
# relative gaps: full NLL 0 (6.2e-8 through create_prior), angle 2.3e-7,
# L2 8.1e-8, mixture mean 2.2e-6 on a near-zero entry (held with atol 1e-7)
PRIOR_RTOL = 1e-5
# the 3x3 normal equations in float32; measured worst relative gap 5.1e-7
TRANSL_RTOL = 1e-3


@pytest.fixture(scope="module")
def priors():
    return jp.synthetic_gmm_prior(seed=4), tp.synthetic_gmm_prior(4, F.CPU)


def _pose(batch, dim=69, seed=0):
    return np.random.default_rng(seed).normal(
        scale=0.3, size=(batch, dim)).astype(np.float32)


def test_gmm_prior_nll_full_matches_jax(priors):
    jprior, tprior = priors
    pose = _pose(5)
    want = np.asarray(jp.gmm_prior_nll_full(jprior, jnp.asarray(pose)))
    got = tp.gmm_prior_nll_full(tprior, torch.as_tensor(pose)).numpy()
    assert got.shape == (5,)
    np.testing.assert_allclose(got, want, rtol=PRIOR_RTOL)


def test_gmm_prior_nll_full_gathers_per_sample(priors):
    """Each sample takes its own argmin component: a batch gives the same
    values as its rows one at a time."""
    _, tprior = priors
    pose = torch.as_tensor(_pose(4, seed=1))
    batched = tp.gmm_prior_nll_full(tprior, pose)
    single = torch.cat([tp.gmm_prior_nll_full(tprior, pose[i:i + 1])
                        for i in range(4)])
    torch.testing.assert_close(batched, single, rtol=0, atol=0)


def test_gmm_mean_pose_matches_jax(priors):
    jprior, tprior = priors
    got = tp.gmm_mean_pose(tprior).numpy()
    assert got.shape == (69,)
    np.testing.assert_allclose(got, np.asarray(jp.gmm_mean_pose(jprior)),
                               rtol=PRIOR_RTOL, atol=1e-7)


@pytest.mark.parametrize("with_global_pose,dim", [(False, 69), (True, 72)])
def test_angle_prior_matches_jax(with_global_pose, dim):
    pose = _pose(3, dim, seed=2)
    want = np.asarray(jp.angle_prior(jnp.asarray(pose), with_global_pose))
    got = tp.angle_prior(torch.as_tensor(pose), with_global_pose).numpy()
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got, want, rtol=PRIOR_RTOL)


def test_l2_prior_matches_jax():
    x = _pose(3, seed=3)
    got = tp.l2_prior(torch.as_tensor(x))
    assert got.shape == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(jp.l2_prior(
        jnp.asarray(x))), rtol=PRIOR_RTOL)


@pytest.mark.parametrize("kind,use_merged,shape", [
    ("gmm", True, (4,)), ("gmm", False, (4,)), ("l2", True, (4,)),
    ("angle", True, (4, 4))])
def test_create_prior_matches_jax(priors, kind, use_merged, shape):
    jprior, tprior = priors
    pose = _pose(4, seed=5)
    betas = _pose(4, 10, seed=6)
    jf = jp.create_prior(kind, jprior, use_merged=use_merged)
    tf = tp.create_prior(kind, tprior, use_merged=use_merged)
    got = tf(torch.as_tensor(pose), torch.as_tensor(betas)).numpy()
    want = np.asarray(jf(jnp.asarray(pose), jnp.asarray(betas)))
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, rtol=PRIOR_RTOL)


@pytest.mark.parametrize("kind", ["none", None])
def test_create_prior_none_is_scalar_zero(kind):
    f = tp.create_prior(kind)
    assert f(torch.ones(2, 69)) == 0.0 == jp.create_prior(kind)(
        jnp.ones((2, 69)))


@pytest.mark.parametrize("kind,prior", [("vposer", None), ("gmm", None)])
def test_create_prior_raises_like_jax(kind, prior):
    with pytest.raises(ValueError):
        tp.create_prior(kind, prior)
    with pytest.raises(ValueError):
        jp.create_prior(kind, prior)


def _correspondences(n_joints, seed, img_size):
    rng = np.random.default_rng(seed)
    S = rng.normal(size=(3, n_joints, 3)).astype(np.float32)
    S[..., 2] += 5.0
    j2d = rng.uniform(0, img_size, size=(3, n_joints, 3)).astype(np.float32)
    j2d[..., 2] = rng.uniform(0.0, 1.0, size=(3, n_joints))
    j2d[0, :3, 2] = 0.0                      # zero-confidence rows
    return S, j2d


@pytest.mark.parametrize("fn,img_size", [("estimate_translation", 224.0),
                                         ("estimate_translation_hmmr", 256.0)])
def test_estimate_translation_matches_jax(fn, img_size):
    S, j2d = _correspondences(19, seed=7, img_size=img_size)
    want = np.asarray(getattr(jcam, fn)(jnp.asarray(S), jnp.asarray(j2d)))
    got = getattr(tcam, fn)(torch.as_tensor(S), torch.as_tensor(j2d)).numpy()
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got, want, rtol=TRANSL_RTOL)


@pytest.mark.parametrize("fn,img_size", [("estimate_translation", 224.0),
                                         ("estimate_translation_hmmr", 256.0)])
def test_estimate_translation_recovers_known_translation(fn, img_size):
    """Project 3D points with a known translation and recover it (the JAX
    package's test_parity_surface recipe)."""
    rng = np.random.default_rng(8)
    f = 5000.0
    S = rng.normal(size=(2, 19, 3)) * 0.3
    t = np.array([[0.05, -0.02, 8.0], [-0.1, 0.03, 12.0]])
    pts = S + t[:, None, :]
    xy = f * pts[..., :2] / pts[..., 2:3] + img_size / 2.0
    j2d = np.concatenate([xy, np.ones_like(xy[..., :1])], -1)
    got = getattr(tcam, fn)(torch.as_tensor(S, dtype=torch.float32),
                            torch.as_tensor(j2d, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), t, rtol=1e-3, atol=1e-3)


def test_original_joints_exactly_equal_jax():
    jmodel = jsmpl.synthetic_smpl_model(seed=0, num_vertices=F.NV)
    tmodel = tsmpl.synthetic_smpl_model(0, F.CPU, num_vertices=F.NV)
    rng = np.random.default_rng(9)
    verts = rng.normal(size=(2, F.NV, 3)).astype(np.float32)
    kin = rng.normal(size=(2, 24, 3)).astype(np.float32)
    want = np.asarray(jsmpl.original_joints(jmodel, jnp.asarray(verts),
                                            jnp.asarray(kin)))
    got = tsmpl.original_joints(tmodel, torch.as_tensor(verts),
                                torch.as_tensor(kin)).numpy()
    assert got.shape == (2, 45, 3)
    np.testing.assert_array_equal(got, want)
