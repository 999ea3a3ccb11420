"""SMPL and the skinning kernel's module: the port against the JAX package
at full size (V = 6890, which the Pallas kernel pads to 7168)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dynaboa_tpu.kernels import PallasSMPL
from dynaboa_tpu.models import smpl as jsmpl
from dynaboa_tpu_torch.kernels import lbs as klbs
from dynaboa_tpu_torch.models import smpl as tsmpl
from tests.test_rotations import random_rotmats
from tests import torch_port_fixtures  # noqa: F401  (shares the cores)

CPU = torch.device("cpu")
# fp32 with another summation order over 207 + 24 terms
VERTS_ATOL = 1e-4
JOINTS_ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    return jsmpl.synthetic_smpl_model(seed=7), tsmpl.synthetic_smpl_model(7, CPU)


def _inputs(rng, n):
    betas = rng.normal(size=(n, 10)).astype(np.float32)
    rotmats = random_rotmats(rng, 24 * n).reshape(n, 24, 3, 3)
    return betas, rotmats


def test_synthetic_model_identical(models):
    jm, tm = models
    for name in ("v_template", "shapedirs", "posedirs", "J_regressor",
                 "lbs_weights", "J_regressor_extra", "vertex_joint_ids"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)), name)
    assert tm.parents == jm.parents
    np.testing.assert_array_equal(tm.faces, jm.faces)


def test_rigid_chain_matches(models, rng):
    jm, tm = models
    _, rotmats = _inputs(rng, 2)
    joints = rng.normal(size=(2, 24, 3)).astype(np.float32)
    jp, jrel = jsmpl._rigid_transform_chain(jnp.asarray(rotmats),
                                            jnp.asarray(joints), jm.parents)
    tp, trel = tsmpl._rigid_transform_chain(torch.as_tensor(rotmats),
                                            torch.as_tensor(joints), tm.parents)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=JOINTS_ATOL)
    np.testing.assert_allclose(trel.numpy(), np.asarray(jrel), atol=1e-5)


def test_eager_lbs_matches_jax(models, rng):
    jm, tm = models
    betas, rotmats = _inputs(rng, 2)
    jv, jj = jsmpl.lbs(jm, jnp.asarray(betas), jnp.asarray(rotmats))
    tv, tj = tsmpl.lbs(tm, torch.as_tensor(betas), torch.as_tensor(rotmats))
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), atol=JOINTS_ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=VERTS_ATOL)


def test_smpl_forward_axis_angle_matches_jax(models, rng):
    jm, tm = models
    betas = rng.normal(size=(3, 10)).astype(np.float32)
    pose = rng.normal(scale=0.3, size=(3, 72)).astype(np.float32)
    jo = jsmpl.smpl_forward(jm, jnp.asarray(betas), jnp.asarray(pose),
                            pose2rot=True)
    to = tsmpl.smpl_forward(tm, torch.as_tensor(betas), torch.as_tensor(pose),
                            pose2rot=True)
    np.testing.assert_allclose(to.vertices.numpy(), np.asarray(jo.vertices),
                               atol=VERTS_ATOL)
    np.testing.assert_allclose(to.joints.numpy(), np.asarray(jo.joints),
                               atol=VERTS_ATOL)
    np.testing.assert_allclose(to.smpl_joints.numpy(),
                               np.asarray(jo.smpl_joints), atol=JOINTS_ATOL)


def test_smpl_forward_gradients_match_jax(models, rng):
    """The eager path is the autograd path of the losses."""
    jm, tm = models
    betas, rotmats = _inputs(rng, 2)
    w = rng.normal(size=(2, 49, 3)).astype(np.float32)

    def jloss(b, r):
        return (jsmpl.smpl_forward(jm, b, r).joints * w).sum()

    jgb, jgr = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(betas),
                                               jnp.asarray(rotmats))
    tb = torch.as_tensor(betas).requires_grad_()
    tr = torch.as_tensor(rotmats).requires_grad_()
    (tsmpl.smpl_forward(tm, tb, tr).joints * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jgb), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(jgr), rtol=1e-4,
                               atol=1e-4)


def test_kernel_module_matches_pallas_interpret(models, rng):
    """CPU dispatch (the plain version) against the Pallas kernel in
    interpret mode, through the padded 6890 -> 7168 layout."""
    jm, tm = models
    betas, rotmats = _inputs(rng, 2)
    jv, jj = PallasSMPL(jm, interpret=True)(jnp.asarray(betas),
                                            jnp.asarray(rotmats))
    with torch.no_grad():
        tv, tj = klbs.LBSKernelSMPL(tm)(torch.as_tensor(betas),
                                        torch.as_tensor(rotmats))
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), atol=JOINTS_ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=VERTS_ATOL)


@pytest.fixture(scope="module")
def small_models():
    """Synthetic bodies by vertex count: full size, the --tiny size and a
    count that leaves a ragged last tile."""
    cache = {}

    def get(V):
        if V not in cache:
            cache[V] = (jsmpl.synthetic_smpl_model(seed=V, num_vertices=V),
                        tsmpl.synthetic_smpl_model(V, CPU, num_vertices=V))
        return cache[V]
    return get


@pytest.mark.parametrize("V", [6890, 256, 100])
@pytest.mark.parametrize("n", [1, 3])
def test_tiled_layout_matches_pallas_interpret(small_models, V, n):
    """The tile-major padded layout through LBSKernelSMPL (the plain
    version on the CPU) against the Pallas kernel in interpret mode."""
    jm, tm = small_models(V)
    betas, rotmats = _inputs(np.random.default_rng(V + n), n)
    jv, jj = PallasSMPL(jm, interpret=True)(jnp.asarray(betas),
                                            jnp.asarray(rotmats))
    k = klbs.LBSKernelSMPL(tm)
    n_tiles = -(-V // klbs.TILE)
    assert k.posedirs_t.shape == (n_tiles, 207, 3, klbs.TILE)
    assert k.weights_t.shape == (n_tiles, 24, klbs.TILE)
    with torch.no_grad():
        tv, tj = k(torch.as_tensor(betas), torch.as_tensor(rotmats))
    assert tv.shape == (n, V, 3)
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), atol=JOINTS_ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=VERTS_ATOL)


@pytest.mark.parametrize("tile", klbs.TILES)
@pytest.mark.parametrize("V", [6890, 100])
def test_tiles_round_trip_and_zero_padding(small_models, tile, V):
    _, tm = small_models(V)
    pd = tm.posedirs.reshape(207, V, 3).permute(0, 2, 1)
    t = klbs.to_tiles(pd, tile)
    n_tiles = -(-V // tile)
    assert t.shape == (n_tiles, 207, 3, tile) and t.is_contiguous()
    assert torch.equal(klbs.from_tiles(t, V), pd)
    assert torch.equal(t[:, 0, 0].reshape(-1)[:V], pd[0, 0])
    assert not t[-1, ..., V - (n_tiles - 1) * tile:].any()


def test_identity_pose_returns_template(models):
    jm, tm = models
    betas = np.zeros((1, 10), np.float32)
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (1, 24, 3, 3)).copy()
    jv, _ = PallasSMPL(jm, interpret=True)(jnp.asarray(betas),
                                           jnp.asarray(eye))
    with torch.no_grad():
        tv, _ = klbs.LBSKernelSMPL(tm)(torch.as_tensor(betas),
                                       torch.as_tensor(eye))
    np.testing.assert_allclose(tv[0].numpy(), tm.v_template.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jv[0]), tm.v_template.numpy(),
                               atol=1e-5)


def test_kernel_module_joints_identical_to_eager(models, rng):
    _, tm = models
    betas, rotmats = (torch.as_tensor(a) for a in _inputs(rng, 3))
    with torch.no_grad():
        ev, ej = tsmpl.lbs(tm, betas, rotmats)
        kv, kj = klbs.LBSKernelSMPL(tm)(betas, rotmats)
    assert torch.equal(kj, ej)
    np.testing.assert_allclose(kv.numpy(), ev.numpy(), atol=VERTS_ATOL)


def test_cpu_dispatch_takes_plain_version(models, rng):
    _, tm = models
    betas, rotmats = (torch.as_tensor(a) for a in _inputs(rng, 1))
    before = klbs.skin.launches
    with torch.no_grad():
        klbs.LBSKernelSMPL(tm)(betas, rotmats)
    assert klbs.skin.launches == before


class TestSkinArgumentChecks:
    @pytest.fixture()
    def args(self, models, rng):
        _, tm = models
        k = klbs.LBSKernelSMPL(tm)
        n, V = 2, tm.v_template.shape[0]
        return dict(
            pose_feature=torch.as_tensor(rng.normal(size=(n, 207)), dtype=torch.float32),
            posedirs_t=k.posedirs_t,
            v_shaped=torch.as_tensor(rng.normal(size=(n, V, 3)), dtype=torch.float32),
            weights_t=k.weights_t,
            rel=torch.as_tensor(rng.normal(size=(n, 24, 4, 4)), dtype=torch.float32))

    def test_accepts_valid(self, args):
        assert klbs.skin(**args).shape == args["v_shaped"].shape

    def test_rejects_wrong_dtype(self, args):
        args["rel"] = args["rel"].double()
        with pytest.raises(TypeError, match="float32"):
            klbs.skin(**args)

    def test_rejects_wrong_shape(self, args):
        args["pose_feature"] = args["pose_feature"][:, :200].contiguous()
        with pytest.raises(ValueError, match="shape"):
            klbs.skin(**args)

    def test_rejects_non_contiguous(self, args):
        args["v_shaped"] = args["v_shaped"].transpose(1, 2).contiguous(
        ).transpose(1, 2)
        with pytest.raises(ValueError, match="contiguous"):
            klbs.skin(**args)

    def test_rejects_unbuilt_tile(self, args, models):
        k = klbs.LBSKernelSMPL(models[1], tile=16)
        args["posedirs_t"], args["weights_t"] = k.posedirs_t, k.weights_t
        with pytest.raises(ValueError, match="tile"):
            klbs.skin(**args)

    def test_rejects_untiled_posedirs(self, args):
        args["posedirs_t"] = klbs.from_tiles(
            args["posedirs_t"], args["v_shaped"].shape[1]).contiguous()
        with pytest.raises(ValueError):
            klbs.skin(**args)

    def test_rejects_grad_inputs(self, args):
        args["rel"].requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            klbs.skin(**args)
