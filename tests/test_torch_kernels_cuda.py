"""The Hopper skinning kernel on the card against its plain PyTorch version.

These tests need a CUDA card and skip without one.  The file imports no jax
(the card's machine has none), so on the card it runs without the suite's
conftest:

  python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from dynaboa_tpu_torch.kernels import lbs as klbs
from dynaboa_tpu_torch.models import smpl as tsmpl

# fp32 with another summation order over 207 + 24 terms
ATOL = 1e-5
RTOL = 1e-5


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, device, seed, identity=False):
    rng = np.random.default_rng(seed)
    betas = rng.normal(size=(n, 10)).astype(np.float32)
    Q, R = np.linalg.qr(rng.normal(size=(n * 24, 3, 3)))
    Q = Q * np.sign(np.diagonal(R, axis1=-2, axis2=-1))[:, None, :]
    Q[np.linalg.det(Q) < 0, :, 0] *= -1
    rot = Q.reshape(n, 24, 3, 3).astype(np.float32)
    if identity:
        betas[:] = 0.0
        rot = np.broadcast_to(np.eye(3, dtype=np.float32), rot.shape).copy()
    return (torch.as_tensor(betas, device=device),
            torch.as_tensor(rot, device=device))


def _skin_args(model, k, betas, rotmats):
    v_shaped, J = tsmpl.shaped_vertices_and_joints(model, betas)
    _, rel = tsmpl._rigid_transform_chain(rotmats, J, model.parents)
    return (tsmpl.pose_features(rotmats), k.posedirs_t, v_shaped.contiguous(),
            k.weights_t, rel.contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 5, 8])
def test_kernel_matches_eager_lbs(cuda_device, n):
    """N=5 and N=8 are partial and full sample groups of the kernel; N=8 is
    the windowed path's batch."""
    model = tsmpl.synthetic_smpl_model(10, cuda_device)
    betas, rotmats = _inputs(n, cuda_device, seed=n)
    before = klbs.skin.launches
    with torch.no_grad():
        kv, kj = klbs.LBSKernelSMPL(model)(betas, rotmats)
        ev, ej = tsmpl.lbs(model, betas, rotmats)
    torch.cuda.synchronize()
    assert klbs.skin.launches == before + 1
    assert torch.equal(kj, ej)
    torch.testing.assert_close(kv, ev, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("V", [100, 256, 6890])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 17])
def test_kernel_matches_plain(cuda_device, n, V):
    """Every sample count up to three groups of 8 (17), the --tiny body
    (V = 256, whole tiles), a ragged last tile (V = 100) and full size."""
    model = tsmpl.synthetic_smpl_model(3, cuda_device, num_vertices=V)
    k = klbs.LBSKernelSMPL(model)
    with torch.no_grad():
        args = _skin_args(model, k, *_inputs(n, cuda_device, seed=V + n))
        kv = klbs.skin(*args)
        pv = klbs.skin_plain(*args)
    torch.cuda.synchronize()
    assert kv.shape == (n, V, 3)
    torch.testing.assert_close(kv, pv, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("tile,warps", [(32, 8), (32, 4), (64, 8), (32, 1)])
def test_kernel_geometries_agree(cuda_device, tile, warps):
    """The geometries chip_smoke.py times give the plain version's result."""
    model = tsmpl.synthetic_smpl_model(4, cuda_device)
    k = klbs.LBSKernelSMPL(model, tile=tile)
    with torch.no_grad():
        args = _skin_args(model, k, *_inputs(8, cuda_device, seed=tile))
        kv = klbs.skin(*args, warps=warps)
        pv = klbs.skin_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(kv, pv, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8])
def test_kernel_identity_pose_returns_template(cuda_device, n):
    model = tsmpl.synthetic_smpl_model(5, cuda_device)
    betas, rotmats = _inputs(n, cuda_device, seed=0, identity=True)
    with torch.no_grad():
        kv, _ = klbs.LBSKernelSMPL(model)(betas, rotmats)
    torch.cuda.synchronize()
    torch.testing.assert_close(kv, model.v_template.expand(n, -1, -1),
                               atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8, 17])
def test_kernel_is_deterministic(cuda_device, n):
    """No atomics and a fixed summation order: two launches, equal bits."""
    model = tsmpl.synthetic_smpl_model(6, cuda_device)
    k = klbs.LBSKernelSMPL(model)
    with torch.no_grad():
        args = _skin_args(model, k, *_inputs(n, cuda_device, seed=n))
        a = klbs.skin(*args)
        b = klbs.skin(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_ragged_vertex_count(cuda_device):
    """V = 100 leaves a partial last tile, whose padding never reaches the
    output."""
    model = tsmpl.synthetic_smpl_model(3, cuda_device, num_vertices=100)
    betas, rotmats = _inputs(2, cuda_device, seed=0)
    with torch.no_grad():
        kv, _ = klbs.LBSKernelSMPL(model)(betas, rotmats)
        ev, _ = tsmpl.lbs(model, betas, rotmats)
    torch.cuda.synchronize()
    torch.testing.assert_close(kv, ev, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_kernel_rejects_cpu_mix(cuda_device):
    model = tsmpl.synthetic_smpl_model(3, cuda_device, num_vertices=100)
    k = klbs.LBSKernelSMPL(model)
    with torch.no_grad(), pytest.raises(ValueError, match="pose_feature"):
        klbs.skin(torch.zeros(1, 207), k.posedirs_t,
                  torch.zeros(1, 100, 3, device=cuda_device), k.weights_t,
                  torch.zeros(1, 24, 4, 4, device=cuda_device))


@pytest.mark.cuda
def test_kernel_rejects_misaligned_layout(cuda_device):
    """The bulk copies need 16-byte aligned tiles: a view 4 bytes into a
    buffer is refused before any launch."""
    model = tsmpl.synthetic_smpl_model(3, cuda_device, num_vertices=100)
    k = klbs.LBSKernelSMPL(model)
    buf = torch.zeros(k.posedirs_t.numel() + 1, device=cuda_device)
    shifted = buf[1:].view(k.posedirs_t.shape)
    shifted.copy_(k.posedirs_t)
    args = list(_skin_args(model, k, *_inputs(1, cuda_device, seed=0)))
    args[1] = shifted
    before = klbs.skin.launches
    with torch.no_grad(), pytest.raises(ValueError, match="aligned"):
        klbs.skin(*args)
    assert klbs.skin.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("warps", [0, 9])
def test_kernel_rejects_bad_warp_count(cuda_device, warps):
    model = tsmpl.synthetic_smpl_model(3, cuda_device, num_vertices=100)
    k = klbs.LBSKernelSMPL(model)
    args = _skin_args(model, k, *_inputs(1, cuda_device, seed=0))
    with torch.no_grad(), pytest.raises(RuntimeError, match="CUDA error"):
        klbs.skin(*args, warps=warps)
