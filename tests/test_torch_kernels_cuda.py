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


def _inputs(n, device, seed):
    rng = np.random.default_rng(seed)
    betas = rng.normal(size=(n, 10)).astype(np.float32)
    Q, R = np.linalg.qr(rng.normal(size=(n * 24, 3, 3)))
    Q = Q * np.sign(np.diagonal(R, axis1=-2, axis2=-1))[:, None, :]
    Q[np.linalg.det(Q) < 0, :, 0] *= -1
    return (torch.as_tensor(betas, device=device),
            torch.as_tensor(Q.reshape(n, 24, 3, 3).astype(np.float32),
                            device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 5])
def test_kernel_matches_eager_lbs(cuda_device, n):
    """N=5 covers a partial second sample group of the kernel."""
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
def test_kernel_ragged_vertex_count(cuda_device):
    """V = 100 leaves a partial 32-vertex block."""
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
        klbs.skin(torch.zeros(1, 207), k.posedirs_k,
                  torch.zeros(1, 100, 3, device=cuda_device), k.weights_k,
                  torch.zeros(1, 24, 4, 4, device=cuda_device))
