"""Losses, the GMM prior and the metrics of the port against the JAX
package, term by term, on the same numpy inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dynaboa_tpu.losses import adaptation as jl
from dynaboa_tpu.losses import priors as jp
from dynaboa_tpu.metrics import eval as jev
from dynaboa_tpu_torch.losses import adaptation as tl
from dynaboa_tpu_torch.losses import priors as tp
from dynaboa_tpu_torch.metrics import eval as tev
from tests import torch_port_fixtures as F
from tests.test_rotations import random_rotmats

CPU = torch.device("cpu")
RTOL = 1e-5   # fp32 reductions in another order
ATOL = 1e-6


def close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def priors():
    path = tp.default_gmm_path()
    assert path is not None and path.endswith("dynaboa_tpu/assets/gmm_08.npz")
    return jp.load_gmm_prior(path), tp.load_gmm_prior(path, CPU)


def kp(rng, n, conf=None):
    c = np.ones((n, 49, 1)) if conf is None else conf
    return np.concatenate([rng.uniform(-1, 1, size=(n, 49, 2)), c],
                          -1).astype(np.float32)


def test_gmm_prior_arrays_identical(priors):
    jprior, tprior = priors
    for a, b in zip(tprior, jprior):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    js, ts = jp.synthetic_gmm_prior(seed=4), tp.synthetic_gmm_prior(4, CPU)
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_gmm_nll_and_gradient_synthetic_prior(rng):
    jprior, tprior = jp.synthetic_gmm_prior(seed=4), tp.synthetic_gmm_prior(4, CPU)
    pose = rng.normal(scale=0.3, size=(4, 69)).astype(np.float32)
    close(tp.gmm_prior_nll(tprior, torch.as_tensor(pose)),
          jp.gmm_prior_nll(jprior, jnp.asarray(pose)), rtol=1e-5, atol=1e-4)
    jg = jax.grad(lambda p: jp.gmm_prior_nll(jprior, p).mean())(
        jnp.asarray(pose))
    t = torch.as_tensor(pose).requires_grad_()
    tp.gmm_prior_nll(tprior, t).mean().backward()
    close(t.grad, jg, rtol=1e-4, atol=1e-4)


def _nll64(prior, pose, weights=None):
    P = prior.precisions.numpy().astype(np.float64)
    d = pose[:, None].astype(np.float64) - prior.means.numpy()[None]
    quad = (np.einsum("mij,bmj->bmi", P, d) * d).sum(-1)
    w = prior.nll_weights.numpy().astype(np.float64) if weights is None \
        else weights
    with np.errstate(divide="ignore"):
        return (0.5 * quad - np.log(w)[None]).min(1)


def test_gmm_nll_shipped_prior_matches_float64(priors, rng):
    """Three of the shipped GMM's eight float32 nll_weights are denormal
    (~1e-40).  The port keeps them, as float64 arithmetic does."""
    _, tprior = priors
    w = tprior.nll_weights.numpy()
    assert ((w > 0) & (w < np.finfo(np.float32).tiny)).sum() == 3
    pose = rng.normal(scale=0.3, size=(4, 69)).astype(np.float32)
    close(tp.gmm_prior_nll(tprior, torch.as_tensor(pose)),
          _nll64(tprior, pose), rtol=1e-5)


def test_gmm_nll_shipped_prior_jax_flushes_denormal_weights(priors, rng):
    """XLA on the CPU flushes denormals to zero, so the JAX package's
    log(nll_weight) is -inf for those components and they never win the
    min; with the denormal weights zeroed, float64 reproduces the JAX
    numbers.  A known divergence of the reference, recorded in ROADMAP.md."""
    jprior, tprior = priors
    pose = rng.normal(scale=0.3, size=(4, 69)).astype(np.float32)
    w = tprior.nll_weights.numpy().astype(np.float64)
    w[w < np.finfo(np.float32).tiny] = 0.0
    np.testing.assert_allclose(
        np.asarray(jp.gmm_prior_nll(jprior, jnp.asarray(pose))),
        _nll64(tprior, pose, weights=w), rtol=1e-5)


def test_shape_prior_with_and_without_rows(rng):
    b = rng.normal(size=(3, 10)).astype(np.float32)
    w = np.array([1.0, 0.0, 1.0], np.float32)
    close(tp.shape_prior(torch.as_tensor(b)), jp.shape_prior(jnp.asarray(b)))
    close(tp.shape_prior(torch.as_tensor(b), torch.as_tensor(w)),
          jp.shape_prior(jnp.asarray(b), jnp.asarray(w)))


@pytest.mark.parametrize("kp_fn", ["keypoint_2d_loss",
                                   "keypoint_2d_loss_openpose"])
def test_keypoint_losses(rng, kp_fn):
    pred = rng.uniform(-1, 1, size=(2, 49, 2)).astype(np.float32)
    gt = kp(rng, 2, conf=rng.uniform(size=(2, 49, 1)))
    w = np.array([1.0, 0.5], np.float32)
    for row_w in (None, w):
        jw = None if row_w is None else jnp.asarray(row_w)
        tw = None if row_w is None else torch.as_tensor(row_w)
        close(getattr(tl, kp_fn)(torch.as_tensor(pred), torch.as_tensor(gt), tw),
              getattr(jl, kp_fn)(jnp.asarray(pred), jnp.asarray(gt), jw))


def test_frame_loss_terms(rng):
    jprior, tprior = jp.synthetic_gmm_prior(seed=4), tp.synthetic_gmm_prior(4, CPU)
    s2d = rng.uniform(-1, 1, size=(2, 49, 2)).astype(np.float32)
    R = random_rotmats(rng, 48).reshape(2, 24, 3, 3)
    shape = rng.normal(size=(2, 10)).astype(np.float32)
    gt = kp(rng, 2)
    jt, jparts = jl.frame_loss(jprior, *map(jnp.asarray, (s2d, R, shape, gt)),
                               10.0, 2e-6, 1e-4)
    tt, tparts = tl.frame_loss(tprior, *map(torch.as_tensor, (s2d, R, shape, gt)),
                               10.0, 2e-6, 1e-4)
    close(tt, jt, rtol=1e-4)
    for k in jparts:
        close(tparts[k], jparts[k], rtol=1e-4, atol=1e-4)


def test_teacher_loss_terms(rng):
    args = [rng.normal(size=s).astype(np.float32) for s in
            ((2, 24, 3, 3), (2, 10), (2, 49, 2), (2, 49, 3))] * 2
    jt, jparts = jl.teacher_loss(*map(jnp.asarray, args))
    tt, tparts = tl.teacher_loss(*map(torch.as_tensor, args))
    close(tt, jt)
    for k in jparts:
        close(tparts[k], jparts[k])


def test_labeled_loss_terms(rng):
    R = random_rotmats(rng, 48).reshape(2, 24, 3, 3)
    args = (R, rng.normal(size=(2, 10)), rng.normal(size=(2, 49, 2)),
            rng.normal(size=(2, 49, 3)), rng.normal(scale=0.2, size=(2, 72)),
            rng.normal(size=(2, 10)), kp(rng, 2),
            np.concatenate([rng.normal(size=(2, 24, 3)),
                            np.ones((2, 24, 1))], -1))
    args = [np.asarray(a, np.float32) for a in args]
    jt, jparts = jl.labeled_loss(*map(jnp.asarray, args))
    tt, tparts = tl.labeled_loss(*map(torch.as_tensor, args))
    close(tt, jt, rtol=1e-5, atol=1e-5)
    for k in jparts:
        close(tparts[k], jparts[k], rtol=1e-5, atol=1e-5)


def test_motion_loss_conf_gating(rng):
    pred, hist_pred = (rng.normal(size=(1, 24, 2)).astype(np.float32)
                       for _ in range(2))
    gt = kp(rng, 1)[:, 25:]
    hist = kp(rng, 1)[:, 25:]
    hist[0, :5, 2] = 0.0          # joints not confident in both frames
    j = jl.motion_loss(*map(jnp.asarray, (pred, gt, hist_pred, hist)))
    t = tl.motion_loss(*map(torch.as_tensor, (pred, gt, hist_pred, hist)))
    close(t, j)


def test_feature_cosine_similarities(rng):
    a = [rng.normal(size=(1, 8, 4, 4)).astype(np.float32) for _ in range(3)]
    b = [x + 0.1 * rng.normal(size=x.shape).astype(np.float32) for x in a]
    b[2] = np.zeros_like(a[2])     # the eps clamp
    j = jl.feature_cosine_similarities([jnp.asarray(x) for x in a],
                                       [jnp.asarray(x) for x in b])
    t = tl.feature_cosine_similarities([torch.as_tensor(x) for x in a],
                                       [torch.as_tensor(x) for x in b])
    close(t, j)


class TestMetrics:
    @pytest.fixture(scope="class")
    def smpls(self):
        return F.jax_smpls(), F.torch_smpls()

    def test_h36m_14_joints(self, smpls, rng):
        js, ts = smpls
        v = rng.normal(size=(2, F.NV, 3)).astype(np.float32)
        close(tev.h36m_14_joints(ts.J_regressor_h36m, torch.as_tensor(v)),
              jev.h36m_14_joints(js.J_regressor_h36m, jnp.asarray(v)),
              atol=1e-5)

    def test_gt_targets_and_evaluate(self, smpls, rng):
        js, ts = smpls
        pose = rng.normal(scale=0.2, size=(2, 72)).astype(np.float32)
        betas = rng.normal(scale=0.3, size=(2, 10)).astype(np.float32)
        gender = np.array([0, 1], np.int32)
        pred = rng.normal(scale=0.5, size=(2, F.NV, 3)).astype(np.float32)
        jt = jev.gt_targets(js, *map(jnp.asarray, (pose, betas, gender)))
        tt = tev.gt_targets(ts, *map(torch.as_tensor, (pose, betas, gender)))
        for k in jt:
            close(tt[k], jt[k], atol=1e-5)
        jm = jev.evaluate_frame(js, *map(jnp.asarray,
                                         (pred, pose, betas, gender)))
        tm = tev.evaluate_frame(ts, *map(torch.as_tensor,
                                         (pred, pose, betas, gender)))
        for k in ("mpjpe", "pampjpe", "pve"):    # mm
            close(tm[k], jm[k], rtol=1e-5, atol=1e-3)

    def test_zero_error_for_perfect_prediction(self, smpls, rng):
        _, ts = smpls
        pose = torch.as_tensor(rng.normal(scale=0.2, size=(2, 72)),
                               dtype=torch.float32)
        betas = torch.as_tensor(rng.normal(size=(2, 10)), dtype=torch.float32)
        gender = torch.zeros(2, dtype=torch.int32)
        from dynaboa_tpu_torch.models.smpl import smpl_forward
        gt = smpl_forward(ts.male, betas, pose, pose2rot=True)
        m = tev.evaluate_frame(ts, gt.vertices, pose, betas, gender)
        np.testing.assert_allclose(m["mpjpe"].numpy(), 0.0, atol=1e-2)
        np.testing.assert_allclose(m["pampjpe"].numpy(), 0.0, atol=1e-2)
